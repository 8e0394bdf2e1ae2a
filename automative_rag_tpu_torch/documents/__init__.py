from .schema import (
    Document,
    INDEXED_KEYWORD_FIELDS,
    INDEXED_NUMERIC_FIELDS,
    INDEXED_FIELDS,
)

__all__ = [
    "Document",
    "INDEXED_KEYWORD_FIELDS",
    "INDEXED_NUMERIC_FIELDS",
    "INDEXED_FIELDS",
]
