"""Per-query-mode parameter tables and CJK-aware token budgeting.

Functional parity target: reference ``src/core/query/llm/mode_config.py``
(:28-142 parameter tables, :203-215 token estimator, :218-279 trimming).
The six query modes and their numeric parameters are behavior-compatible so
that retrieval depth, context budgets, and generation knobs match the
reference system end to end.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple


class QueryMode(str, Enum):
    FACTS = "facts"
    FEATURES = "features"
    TRADEOFFS = "tradeoffs"
    SCENARIOS = "scenarios"
    DEBATE = "debate"
    QUOTES = "quotes"

    @classmethod
    def parse(cls, value) -> "QueryMode":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            return cls.FACTS


@dataclass(frozen=True)
class ModeParams:
    # generation
    temperature: float
    max_tokens: int
    top_p: float
    repetition_penalty: float
    # retrieval / filtering
    retrieval_k: int
    final_k: int
    relevance_cutoff: float
    confidence_cutoff: float
    # context budget
    max_context_tokens: int
    docs_per_source: int
    prioritize_numerical: bool
    complexity: str = "moderate"


_MODE_TABLE: Dict[QueryMode, ModeParams] = {
    QueryMode.FACTS: ModeParams(
        temperature=0.0, max_tokens=400, top_p=0.8, repetition_penalty=1.15,
        retrieval_k=20, final_k=8, relevance_cutoff=0.3, confidence_cutoff=0.7,
        max_context_tokens=2000, docs_per_source=2, prioritize_numerical=True,
        complexity="simple",
    ),
    QueryMode.FEATURES: ModeParams(
        temperature=0.1, max_tokens=600, top_p=0.85, repetition_penalty=1.1,
        retrieval_k=30, final_k=12, relevance_cutoff=0.25, confidence_cutoff=0.6,
        max_context_tokens=3000, docs_per_source=3, prioritize_numerical=False,
        complexity="moderate",
    ),
    QueryMode.TRADEOFFS: ModeParams(
        temperature=0.15, max_tokens=700, top_p=0.9, repetition_penalty=1.1,
        retrieval_k=35, final_k=15, relevance_cutoff=0.2, confidence_cutoff=0.5,
        max_context_tokens=3500, docs_per_source=3, prioritize_numerical=False,
        complexity="complex",
    ),
    QueryMode.SCENARIOS: ModeParams(
        temperature=0.12, max_tokens=650, top_p=0.87, repetition_penalty=1.1,
        retrieval_k=30, final_k=12, relevance_cutoff=0.25, confidence_cutoff=0.6,
        max_context_tokens=3200, docs_per_source=3, prioritize_numerical=False,
        complexity="complex",
    ),
    QueryMode.DEBATE: ModeParams(
        temperature=0.2, max_tokens=800, top_p=0.92, repetition_penalty=1.05,
        retrieval_k=40, final_k=18, relevance_cutoff=0.2, confidence_cutoff=0.5,
        max_context_tokens=4000, docs_per_source=4, prioritize_numerical=False,
        complexity="complex",
    ),
    QueryMode.QUOTES: ModeParams(
        temperature=0.05, max_tokens=500, top_p=0.75, repetition_penalty=1.2,
        retrieval_k=25, final_k=10, relevance_cutoff=0.3, confidence_cutoff=0.65,
        max_context_tokens=2500, docs_per_source=2, prioritize_numerical=False,
        complexity="simple",
    ),
}


class ModeConfig:
    """Lookup facade over the mode parameter table."""

    def params(self, mode) -> ModeParams:
        return _MODE_TABLE[QueryMode.parse(mode)]

    def get_llm_params(self, mode) -> Dict[str, Any]:
        p = self.params(mode)
        return {
            "temperature": p.temperature,
            "max_tokens": p.max_tokens,
            "top_p": p.top_p,
            "repetition_penalty": p.repetition_penalty,
        }

    def get_retrieval_params(self, mode) -> Dict[str, Any]:
        p = self.params(mode)
        return {
            "retrieval_k": p.retrieval_k,
            "final_k": p.final_k,
            "relevance_cutoff": p.relevance_cutoff,
            "confidence_cutoff": p.confidence_cutoff,
        }

    def get_context_params(self, mode) -> Dict[str, Any]:
        p = self.params(mode)
        return {
            "max_context_tokens": p.max_context_tokens,
            "docs_per_source": p.docs_per_source,
            "prioritize_numerical": p.prioritize_numerical,
        }

    def should_trim_low_relevance(self, mode, relevance_score: float) -> bool:
        return relevance_score < self.params(mode).relevance_cutoff

mode_config = ModeConfig()


def estimate_token_count(text: str) -> int:
    """CJK-aware rough token estimate.

    Chinese characters count ~1.5 tokens each; the remaining characters are
    treated as English at ~4 chars/word × 1.3 tokens/word (reference
    ``mode_config.py:203-215`` semantics).
    """
    chinese = sum(1 for c in text if "一" <= c <= "鿿")
    other = len(text) - chinese
    return int(chinese * 1.5 + (other / 4) * 1.3)


def _doc_fields(doc) -> Tuple[str, dict]:
    content = getattr(doc, "page_content", None)
    if content is None:
        content = str(doc)
    metadata = getattr(doc, "metadata", None) or {}
    return content, metadata


def trim_documents_by_tokens(
    documents: Sequence,
    mode,
    max_tokens: Optional[int] = None,
) -> List[Tuple[Any, float]]:
    """Greedy highest-relevance packing under a per-mode token budget.

    Accepts either ``(doc, score)`` tuples or bare docs; enforces the mode's
    relevance cutoff and per-source diversity cap, and stops once the budget
    would be exceeded (always keeping at least one doc).
    """
    if not documents:
        return []

    ctx = mode_config.get_context_params(mode)
    budget = max_tokens or ctx["max_context_tokens"]
    max_per_source = ctx["docs_per_source"]

    if isinstance(documents[0], tuple):
        ranked = sorted(documents, key=lambda pair: pair[1], reverse=True)
    else:
        ranked = [(doc, 1.0) for doc in documents]

    selected: List[Tuple[Any, float]] = []
    total = 0
    per_source: Dict[str, int] = {}
    for doc, score in ranked:
        if mode_config.should_trim_low_relevance(mode, score):
            continue
        content, metadata = _doc_fields(doc)
        source_id = metadata.get("source_id", "unknown")
        if per_source.get(source_id, 0) >= max_per_source:
            continue
        doc_tokens = estimate_token_count(content)
        if selected and total + doc_tokens > budget:
            break
        selected.append((doc, score))
        total += doc_tokens
        per_source[source_id] = per_source.get(source_id, 0) + 1
    return selected
