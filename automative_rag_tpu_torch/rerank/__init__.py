from .reranker import LateInteractionReranker
from .token_store import TokenStore

__all__ = ["LateInteractionReranker", "TokenStore"]
