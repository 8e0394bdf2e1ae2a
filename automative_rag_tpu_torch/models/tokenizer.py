"""Tokenizers for the encoders.

Two backends behind one interface:

- ``HFTokenizer`` — wraps a local HuggingFace tokenizer directory (the
  production path for real bge-m3 / ColBERT checkpoints; the reference loads
  tokenizers the same local-files-only way, ``settings.py:233-249``).
- ``HashTokenizer`` — a deterministic, dependency-free fallback: CJK chars
  are split as single tokens (bge-m3's sentencepiece does roughly this for
  Chinese), Latin text by word pieces, ids assigned by stable hashing. It
  keeps the whole pipeline runnable (tests, benches, weightless deploys)
  with identical shapes/masks to the real tokenizer.

Both return fixed-length ``(input_ids, attention_mask)`` numpy batches, as
the JAX package's tokenizers do, so both packages see the same ids.
"""

from __future__ import annotations

import ctypes
import os
import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
_RESERVED = 4

_TOKEN_RE = re.compile(
    r"[一-鿿]|[a-zA-Z]+|[0-9]+(?:\.[0-9]+)?|[^\sa-zA-Z0-9一-鿿]"
)

_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_U64 = (1 << 64) - 1


def _fnv1a64(data: bytes) -> int:
    value = _FNV_OFFSET
    for byte in data:
        value = ((value ^ byte) * _FNV_PRIME) & _U64
    return value


def _stable_hash(token: str, vocab_size: int) -> int:
    return _RESERVED + _fnv1a64(token.lower().encode("utf-8")) % (
        vocab_size - _RESERVED
    )


# ------------------------------------------------------------- native path

def _load_native() -> Optional[ctypes.CDLL]:
    """Load the C tokenizer hot loop (native/libfasttok.so) if built; the
    Python fallback implements the identical algorithm (FNV-1a64 on
    lowercased UTF-8), so ids are bit-identical either way."""
    candidates = [
        os.environ.get("FASTTOK_LIB", ""),
        str(Path(__file__).resolve().parents[2] / "native" / "libfasttok.so"),
    ]
    for candidate in candidates:
        if candidate and Path(candidate).exists():
            try:
                lib = ctypes.CDLL(candidate)
                lib.fasttok_encode.restype = ctypes.c_int
                lib.fasttok_encode.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
                    ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
                ]
                return lib
            except OSError:
                continue
    return None


_NATIVE: Optional[ctypes.CDLL] = None
_NATIVE_TRIED = False


def _native() -> Optional[ctypes.CDLL]:
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE = _load_native()
        _NATIVE_TRIED = True
    return _NATIVE


class HashTokenizer:
    """Deterministic hash tokenizer with CJK-aware splitting.

    The encode hot loop runs in C when ``native/libfasttok.so`` is built
    (``native/build.sh``); pure-Python fallback is bit-identical.
    """

    def __init__(self, vocab_size: int = 32768, use_native: bool = True):
        self.vocab_size = vocab_size
        self.pad_token_id = PAD_ID
        self.cls_token_id = CLS_ID
        self.sep_token_id = SEP_ID
        self._lib = _native() if use_native else None

    def tokenize(self, text: str) -> List[str]:
        return _TOKEN_RE.findall(text.lower())

    def _encode_ids(self, text: str, max_tokens: int) -> List[int]:
        if self._lib is not None:
            raw = text.encode("utf-8")
            buf = (ctypes.c_uint32 * max_tokens)()
            n = self._lib.fasttok_encode(
                raw, len(raw), self.vocab_size, buf, max_tokens
            )
            return list(buf[:n])
        toks = self.tokenize(text)[:max_tokens]
        return [_stable_hash(t, self.vocab_size) for t in toks]

    def encode_batch(
        self, texts: Sequence[str], max_length: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(texts)
        ids = np.full((n, max_length), PAD_ID, np.int32)
        mask = np.zeros((n, max_length), np.int32)
        for i, text in enumerate(texts):
            toks = self._encode_ids(text, max_length - 2)
            row = [CLS_ID] + toks + [SEP_ID]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask


class HFTokenizer:
    """Local-files-only HuggingFace tokenizer wrapper."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # lazy; heavy import

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = self._tok.vocab_size
        self.pad_token_id = self._tok.pad_token_id or 0
        self.cls_token_id = self._tok.cls_token_id
        self.sep_token_id = self._tok.sep_token_id

    def encode_batch(
        self, texts: Sequence[str], max_length: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        enc = self._tok(
            list(texts),
            add_special_tokens=True,
            max_length=max_length,
            padding="max_length",
            truncation=True,
            return_tensors="np",
        )
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)


def load_tokenizer(path: str = "", vocab_size: int = 32768):
    """HF tokenizer if a local directory exists, else the hash fallback."""
    if path and Path(path).exists():
        try:
            return HFTokenizer(path)
        except Exception:
            pass
    return HashTokenizer(vocab_size=vocab_size)
