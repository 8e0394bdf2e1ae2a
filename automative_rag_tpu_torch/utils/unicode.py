"""Unicode escape repair for Chinese text crossing JSON/queue boundaries.

Parity target: reference ``src/utils/unicode_handler.py`` (repair of
``\\uXXXX``/``\\xXX`` literals leaking into strings) and the actor-argument
cleaning the reference monkey-patches into its broker
(``src/core/background/unicode_actor.py``) — here the queue manager calls
``clean_unicode_escapes`` on task payloads directly instead of patching.
"""

from __future__ import annotations

import json
import re
from typing import Any

_U_ESCAPE = re.compile(r"\\u([0-9a-fA-F]{4})")
_X_ESCAPE = re.compile(r"\\x([0-9a-fA-F]{2})")


def decode_unicode_escapes(text: str) -> str:
    """Repair literal ``\\uXXXX`` / ``\\xXX`` sequences inside a string."""
    if not isinstance(text, str) or "\\" not in text:
        return text

    def _u(match):
        try:
            return chr(int(match.group(1), 16))
        except ValueError:
            return match.group(0)

    def _x(match):
        try:
            return chr(int(match.group(1), 16))
        except ValueError:
            return match.group(0)

    return _X_ESCAPE.sub(_x, _U_ESCAPE.sub(_u, text))


def clean_unicode_escapes(data: Any) -> Any:
    """Recursively repair unicode escapes in nested containers."""
    if isinstance(data, str):
        return decode_unicode_escapes(data)
    if isinstance(data, dict):
        return {clean_unicode_escapes(k): clean_unicode_escapes(v) for k, v in data.items()}
    if isinstance(data, list):
        return [clean_unicode_escapes(v) for v in data]
    if isinstance(data, tuple):
        return tuple(clean_unicode_escapes(v) for v in data)
    return data


def safe_json_dumps(data: Any, **kwargs) -> str:
    """JSON dump that keeps CJK readable (``ensure_ascii=False``)."""
    kwargs.setdefault("ensure_ascii", False)
    return json.dumps(clean_unicode_escapes(data), **kwargs)
