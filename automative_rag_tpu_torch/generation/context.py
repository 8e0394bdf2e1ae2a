"""Relevance-annotated context building under a token budget.

Parity target: reference ``format_documents_with_relevance_scores``
(``src/core/query/llm/local_llm.py:17-117``): docs sorted by relevance, each
block headed by a DOC_i citation id + source info + relevance indicator
(🔥/⭐/📄), greedy packing under the budget with truncation of high-relevance
overflow docs, 12-doc hard cap.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..config.mode_config import estimate_token_count
from ..documents.schema import Document

MAX_CONTEXT_DOCS = 12

_SOURCE_LABEL = {"youtube": "YouTube", "bilibili": "Bilibili", "pdf": "PDF", "text": "Text"}


def _relevance_indicator(score: float) -> str:
    if score > 0.8:
        return "🔥"
    if score > 0.6:
        return "⭐"
    return "📄"


def _source_header(doc: Document, doc_id: str, score: float) -> str:
    md = doc.metadata
    source = md.get("source", "unknown")
    title = md.get("title") or md.get("source_id") or "untitled"
    label = _SOURCE_LABEL.get(source)
    header = f"{doc_id} ({label} - '{title}')" if label else f"{doc_id} ({title})"
    brand_bits = " ".join(str(md[k]) for k in ("manufacturer", "model") if md.get(k))
    if brand_bits:
        header += f" - {brand_bits}"
    header += f" {_relevance_indicator(score)} (Relevance: {score:.2f})"
    return header


def format_documents_with_relevance_scores(
    documents: List[Tuple[Document, float]],
    max_token_budget: Optional[int] = None,
) -> str:
    """Build the LLM context string; returns doc blocks tagged DOC_1..DOC_n
    in relevance order."""
    if not documents:
        return "No relevant documents found."

    ranked = sorted(documents, key=lambda p: p[1], reverse=True)
    parts: List[str] = []
    used_tokens = 0

    for i, (doc, score) in enumerate(ranked[:MAX_CONTEXT_DOCS]):
        doc_id = f"DOC_{i + 1}"
        header = _source_header(doc, doc_id, score)
        block = f"{header}\n{doc.page_content}\n"

        if max_token_budget is not None:
            block_tokens = estimate_token_count(block)
            if used_tokens + block_tokens > max_token_budget:
                # high-relevance overflow: include a truncated tail slice
                if score > 0.7 and used_tokens < max_token_budget * 0.8:
                    remaining = max_token_budget - used_tokens - estimate_token_count(header)
                    # chars-per-token measured on this doc (CJK ≈ 0.67,
                    # English ≈ 3; the reference's fixed 2.5 overshoots CJK)
                    ratio = len(doc.page_content) / max(
                        estimate_token_count(doc.page_content), 1
                    )
                    max_chars = int(remaining * ratio)
                    if max_chars > 100:
                        parts.append(f"{header}\n{doc.page_content[:max_chars]}... [截断]\n")
                break
            used_tokens += block_tokens
        parts.append(block)

    return "\n\n".join(parts)


def documents_in_context_order(
    documents: List[Tuple[Document, float]],
) -> List[Tuple[str, Document, float]]:
    """(doc_id, doc, score) in the same DOC_i order the context assigns —
    used to resolve 【来源：DOC_X】 citations back to documents."""
    ranked = sorted(documents, key=lambda p: p[1], reverse=True)[:MAX_CONTEXT_DOCS]
    return [(f"DOC_{i + 1}", doc, score) for i, (doc, score) in enumerate(ranked)]
