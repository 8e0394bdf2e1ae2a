from .context import format_documents_with_relevance_scores
from .prompts import build_prompt, CITATION_MARK
from .fact_check import SimpleFactChecker
from .llm import AnswerGenerator, StubLLM, load_llm

__all__ = [
    "format_documents_with_relevance_scores",
    "build_prompt",
    "CITATION_MARK",
    "SimpleFactChecker",
    "AnswerGenerator",
    "StubLLM",
    "load_llm",
]
