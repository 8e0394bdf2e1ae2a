from .retrieval import RetrievalEngine

__all__ = ["RetrievalEngine"]
