"""Text cleaning and lightweight metadata extraction helpers.

Parity target: reference ``src/utils/helpers.py`` (text cleaning, year
extraction, metadata-from-text).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

_WS = re.compile(r"\s+")
_CTRL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")


def clean_text(text: str) -> str:
    """Collapse whitespace and strip control characters."""
    if not text:
        return ""
    return _WS.sub(" ", _CTRL.sub("", text)).strip()


_YEAR_PATTERNS = (
    re.compile(r"(20[0-3][0-9])\s*款"),  # Chinese model-year suffix
    re.compile(r"\b(20[0-3][0-9])\b"),
    re.compile(r"\b(19[89][0-9])\b"),
)


def extract_year_from_text(text: str) -> Optional[int]:
    for pattern in _YEAR_PATTERNS:
        match = pattern.search(text)
        if match:
            return int(match.group(1))
    return None


def extract_metadata_from_text(text: str) -> Dict[str, Any]:
    """Best-effort year/spec hints from free text (full automotive metadata
    extraction lives in ``ingestion.metadata``)."""
    metadata: Dict[str, Any] = {}
    year = extract_year_from_text(text)
    if year:
        metadata["year"] = year
    return metadata
