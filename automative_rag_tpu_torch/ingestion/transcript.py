"""Transcript/content processor: metadata extraction + chunking + 【k:v】
injection + structured metadata.

Capability parity with the reference's ``EnhancedTranscriptProcessor``
(``enhanced_transcript_processor.py:432-610``): every ingestion type funnels
through this processor; it builds the "raw original" field from source
metadata, extracts automotive fields, chunks the content (CJK-aware), and
prefixes each chunk with compact English-keyed metadata markers
(``【brand:X】【model:Y】【year:Z】…``) so the embedding carries the filters'
signal; structured metadata includes chunk bookkeeping + extraction stats.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Optional

from ..config.settings import settings
from ..documents.schema import Document
from .chunker import split_text
from .metadata import MetadataExtractor

# explicit source-metadata keys that override extracted fields: a caller who
# passes manufacturer="小米" must not have it silently dropped just because
# the extractor's alias catalog doesn't know the brand (the extractor would
# leave the field None and the None-strip would erase the user's value)
_USER_FIELD_KEYS = (
    ("manufacturer", "manufacturer"),
    ("model", "model"),
    ("year", "modelYear"),
    ("category", "vehicleType"),
    ("engine_type", "fuelType"),
    ("transmission", "transmission"),
)

def extract_keywords(text: str, top_k: int = 8) -> List[str]:
    """Per-document keyword analysis for transcript enrichment.

    The reference imports ``jieba.analyse`` for this in its transcript
    processor (``enhanced_transcript_processor.py:2-3``) but never calls
    it; here the keywords are real: jieba TF-IDF when the package is
    importable, with a CJK-bigram frequency fallback that needs nothing.
    Stored in chunk metadata (``keywords``) and shown in the UI metadata
    card."""
    text = text[:4000]
    if not text.strip():
        return []
    try:
        import jieba.analyse

        tags = jieba.analyse.extract_tags(text, topK=top_k)
        if tags:
            return [str(t) for t in tags]
    except Exception:  # noqa: BLE001 — fall back to the built-in analyser
        pass
    # fallback: frequency over CJK bigrams + latin words, stopword-light
    import re as _re
    from collections import Counter

    counts: Counter = Counter()
    for match in _re.finditer(r"[一-鿿]{2,}|[A-Za-z][A-Za-z0-9-]{2,}",
                              text):
        token = match.group(0)
        if token.isascii():
            counts[token.lower()] += 1
        else:
            for i in range(len(token) - 1):
                counts[token[i : i + 2]] += 1
    return [w for w, _ in counts.most_common(top_k)]


# injected marker key order (reference _create_enhanced_document :500-560)
_MARKER_KEYS = (
    ("manufacturer", "brand"),
    ("model", "model"),
    ("modelYear", "year"),
    ("vehicleType", "type"),
    ("fuelType", "fuel"),
    ("transmission", "trans"),
    ("authorName", "author"),
    ("viewsCount", "views"),
    ("sourcePlatform", "source"),
)


class TranscriptProcessor:
    def __init__(self, chunk_size: Optional[int] = None, chunk_overlap: Optional[int] = None):
        self.extractor = MetadataExtractor()
        self.chunk_size = chunk_size or settings.chunk_size
        self.chunk_overlap = chunk_overlap or settings.chunk_overlap

    # ------------------------------------------------------------ helpers
    def build_raw_original(self, source_metadata: Dict[str, Any]) -> str:
        """Compose the raw source-description line the extractor mines
        (title / author / views / platform), mirroring the reference's
        video-metadata format builder (:466-498)."""
        parts = []
        if source_metadata.get("title"):
            parts.append(str(source_metadata["title"]))
        if source_metadata.get("author"):
            parts.append(f"author: {source_metadata['author']}")
        if source_metadata.get("views") is not None:
            parts.append(f"views: {source_metadata['views']}")
        if source_metadata.get("source"):
            parts.append(f"source: {source_metadata['source']}")
        if source_metadata.get("description"):
            parts.append(str(source_metadata["description"])[:300])
        return " | ".join(parts)

    def _markers(self, fields: Dict[str, Any], remaining: str) -> str:
        parts = [
            f"【{short}:{fields[key]}】"
            for key, short in _MARKER_KEYS
            if fields.get(key) not in (None, "")
        ]
        if remaining:
            parts.append(f"【other:{remaining[:100] + ('...' if len(remaining) > 100 else '')}】")
        return "".join(parts)

    # -------------------------------------------------------------- main
    def process(
        self,
        content: str,
        source_metadata: Optional[Dict[str, Any]] = None,
        source: str = "text",
        source_id: Optional[str] = None,
    ) -> List[Document]:
        """content + source metadata → enhanced chunk Documents."""
        source_metadata = dict(source_metadata or {})
        raw_original = self.build_raw_original(source_metadata)

        # extract from the raw-original line first (rich fields), then let
        # the content itself fill the gaps
        fields, remaining = self.extractor.extract_and_remove(raw_original)
        content_fields = self.extractor.extract(content[:2000])
        for key, value in content_fields.items():
            fields.setdefault(key, value)
        # explicit caller metadata wins over regex extraction, and lands in
        # the markers below so the embedding carries the signal too
        for meta_key, field_key in _USER_FIELD_KEYS:
            value = source_metadata.get(meta_key)
            if value not in (None, ""):
                fields[field_key] = value

        if source_id is None:
            basis = (source_metadata.get("url") or content[:256]).encode("utf-8")
            source_id = hashlib.blake2s(basis, digest_size=8).hexdigest()

        chunks = split_text(content, self.chunk_size, self.chunk_overlap)
        marker_prefix = self._markers(fields, remaining)
        keywords = extract_keywords(content)
        now = int(time.time())

        documents: List[Document] = []
        for index, chunk in enumerate(chunks):
            text = f"{marker_prefix}\n\n{chunk}" if marker_prefix else chunk
            metadata = {
                # indexed filter fields (documents/schema.py)
                "manufacturer": fields.get("manufacturer"),
                "model": fields.get("model"),
                "year": fields.get("modelYear"),
                "category": fields.get("vehicleType"),
                "engine_type": fields.get("fuelType"),
                "transmission": fields.get("transmission"),
                "source": source,
                "source_id": source_id,
                "ingestion_time": now,
                # bookkeeping + provenance
                "chunk_id": f"{source_id}-{index}",
                "chunk_index": index,
                "total_chunks": len(chunks),
                "title": source_metadata.get("title"),
                "url": source_metadata.get("url"),
                "author": fields.get("authorName") or source_metadata.get("author"),
                "views": fields.get("viewsCount"),
                "language": source_metadata.get("language"),
                # extraction stats
                "vehicle_detected": self.extractor.vehicle_detected(fields),
                "metadata_injected": bool(marker_prefix),
                "chunk_chars": len(chunk),
                # document-level keyword analysis (jieba TF-IDF / fallback)
                "keywords": ", ".join(keywords) if keywords else None,
            }
            # propagate remaining scalar source metadata (pages, used_ocr,
            # duration, ...) without clobbering extracted fields
            for key, value in source_metadata.items():
                if isinstance(value, (str, int, float, bool)):
                    metadata.setdefault(key, value)
            metadata = {k: v for k, v in metadata.items() if v is not None}
            documents.append(Document(page_content=text, metadata=metadata))
        return documents
