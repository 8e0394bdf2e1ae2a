from .settings import Settings, settings
from .mode_config import (
    QueryMode,
    ModeConfig,
    mode_config,
    estimate_token_count,
    trim_documents_by_tokens,
)

__all__ = [
    "Settings",
    "settings",
    "QueryMode",
    "ModeConfig",
    "mode_config",
    "estimate_token_count",
    "trim_documents_by_tokens",
]
