"""Document/chunk data model and the indexed metadata schema.

Parity target: the reference indexes nine payload fields in Qdrant
(``src/core/query/retrieval/vectorstore.py:89-122``) — seven KEYWORD fields
and two INTEGER fields (``year``, ``ingestion_time``). Here the same schema
drives the columnar metadata store that filter bitmasks are computed from.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# KEYWORD-typed indexed fields (string equality / OR-list filters)
INDEXED_KEYWORD_FIELDS = (
    "manufacturer",
    "model",
    "category",
    "engine_type",
    "transmission",
    "source",
    "source_id",
)

# INTEGER-typed indexed fields (equality and range filters)
INDEXED_NUMERIC_FIELDS = ("year", "ingestion_time")

INDEXED_FIELDS = INDEXED_KEYWORD_FIELDS + INDEXED_NUMERIC_FIELDS


@dataclass
class Document:
    """A text chunk plus metadata — the unit stored in the vector index."""

    page_content: str
    metadata: Dict[str, Any] = field(default_factory=dict)
    id: Optional[str] = None

    def __post_init__(self):
        if self.id is None:
            self.id = self.metadata.get("id") or str(uuid.uuid4())
        self.metadata.setdefault("id", self.id)

    def stamp_ingestion(self, job_id: Optional[str] = None) -> "Document":
        """Stamp ingestion-time bookkeeping fields (reference
        ``vectorstore.py:124-164`` stamps id/ingestion_time at add time)."""
        self.metadata.setdefault("ingestion_time", int(time.time()))
        if job_id is not None:
            self.metadata.setdefault("job_id", job_id)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {"id": self.id, "page_content": self.page_content, "metadata": self.metadata}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Document":
        return cls(
            page_content=d.get("page_content", ""),
            metadata=dict(d.get("metadata", {})),
            id=d.get("id"),
        )
