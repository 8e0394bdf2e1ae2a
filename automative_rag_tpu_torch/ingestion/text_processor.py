"""Manual-text ingestion processor (reference
``src/core/ingestion/processors/text_processor.py``)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ..utils.text import clean_text
from .base import BaseIngestionProcessor


class TextProcessor(BaseIngestionProcessor):
    source_type = "text"

    def validate_source(self, source: Any) -> Tuple[bool, str]:
        if isinstance(source, dict):
            source = source.get("content", "")
        if not isinstance(source, str):
            return False, "expected str or {'content': str}"
        if not source.strip():
            return False, "empty text"
        return True, ""

    def extract_raw_content(self, source: Any) -> Tuple[str, Dict[str, Any]]:
        metadata: Dict[str, Any] = {}
        if isinstance(source, dict):
            metadata = {k: v for k, v in source.items() if k != "content"}
            source = source.get("content", "")
        return clean_text(source), metadata
