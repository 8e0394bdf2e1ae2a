"""Template-method base for ingestion processors.

Parity target: reference ``BaseIngestionProcessor``
(``src/core/ingestion/base/processor.py:63-145``): per-type
``validate_source`` + ``extract_raw_content``, with a shared ``process()``
that funnels every source type (text/pdf/video) through the transcript
processor so chunking/metadata-injection behavior is identical everywhere.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple

from ..documents.schema import Document
from .transcript import TranscriptProcessor


class BaseIngestionProcessor(ABC):
    source_type: str = "unknown"

    def __init__(self, transcript_processor: Optional[TranscriptProcessor] = None):
        self.transcript_processor = transcript_processor or TranscriptProcessor()
        self.stats: Dict[str, Any] = {"processed": 0, "chunks": 0, "errors": 0}

    @abstractmethod
    def validate_source(self, source: Any) -> Tuple[bool, str]:
        """→ (ok, reason)."""

    @abstractmethod
    def extract_raw_content(self, source: Any) -> Tuple[str, Dict[str, Any]]:
        """→ (content text, source metadata)."""

    def process(self, source: Any, source_id: Optional[str] = None) -> List[Document]:
        ok, reason = self.validate_source(source)
        if not ok:
            self.stats["errors"] += 1
            raise ValueError(f"invalid {self.source_type} source: {reason}")
        t0 = time.perf_counter()
        content, source_metadata = self.extract_raw_content(source)
        documents = self.transcript_processor.process(
            content,
            source_metadata=source_metadata,
            source=self.source_type,
            source_id=source_id,
        )
        self.stats["processed"] += 1
        self.stats["chunks"] += len(documents)
        self.stats["last_seconds"] = round(time.perf_counter() - t0, 4)
        return documents
