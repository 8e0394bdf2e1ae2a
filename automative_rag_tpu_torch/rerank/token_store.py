"""Corpus token-embedding store for rerank-from-store (PyTorch port of
``automative_rag_tpu/rerank/token_store.py``, ``quantize="none"`` only).

ColBERT token embeddings are computed once at ingest and stored
row-aligned with the vector index; query-time rerank is one K1 launch that
gathers the candidate slabs by row id and scores them (``maxsim_fused``).

Storage: the device buffer is primary — a doc-major ``[cap, Ld, D]``
tensor (bf16 by default) with geometric capacity headroom, written in place
on append, plus a ``[cap, Ld]`` bool mask buffer; the host keeps only the
masks. Tokens round fp32 → fp16 → device dtype, the JAX store's rounding
points (fp16 host array, then the device cast). ``save`` reads the buffer
back as fp16 in the JAX package's ``token_store.npz`` format.

A corpus whose token slabs exceed ``device_budget_bytes`` raises on append:
the host-gather fallback of the JAX store, and its ``int8`` and
``residual2`` modes, are not ported yet.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..ops.maxsim import maxsim_gather

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class TokenStore:
    def __init__(
        self,
        dim: int,
        max_doc_length: int,
        device_dtype: str = "bfloat16",
        device_budget_bytes: int = 4 * 1024**3,
        quantize: str = "none",
        device="cuda",
    ):
        if quantize != "none":
            raise NotImplementedError(
                f"token store quantize={quantize!r} is not ported yet "
                "(only 'none')")
        if str(device_dtype) not in _DTYPES:
            raise NotImplementedError(f"token store dtype {device_dtype!r}")
        self.dim = dim
        self.max_doc_length = max_doc_length
        self.device = resolve_device(device)
        self.device_dtype = _DTYPES[str(device_dtype)]
        if self.device.type == "cuda" and self.device_dtype != torch.bfloat16:
            raise NotImplementedError(
                f"a {device_dtype} token store on the card: K1 reads bf16 "
                "tokens, and only the bf16 store is ported")
        self.device_budget_bytes = device_budget_bytes
        self.quantize = quantize
        self._masks = np.zeros((0, max_doc_length), bool)  # host mirror
        self._buf: Optional[torch.Tensor] = None  # [cap, Ld, D]
        self._mask_buf: Optional[torch.Tensor] = None  # [cap, Ld] bool
        self._rows = 0
        # appends (ingestion) can race gathers (queries)
        self._mutex = threading.RLock()

    # ------------------------------------------------------------- sizes
    @property
    def rows(self) -> int:
        return self._rows

    @property
    def _element_bytes(self) -> int:
        return self.dim * torch.tensor([], dtype=self.device_dtype).element_size()

    def _grow_cap(self, rows: int) -> int:
        cap = 1024
        while cap < rows:
            cap *= 2
        max_cap = self.device_budget_bytes // max(
            1, self.max_doc_length * self._element_bytes)
        return max(rows, min(cap, max_cap))

    # ---------------------------------------------------------- mutation
    def append(self, token_embs, masks) -> None:
        """Append rows (row order must mirror the vector index): token_embs
        [N, Ld, D] (tensor on any device, or numpy), masks [N, Ld]."""
        masks = np.asarray(masks, bool)
        tokens = torch.as_tensor(token_embs)
        if tuple(tokens.shape[1:]) != (self.max_doc_length, self.dim):
            raise ValueError(
                f"expected [N, {self.max_doc_length}, {self.dim}], "
                f"got {tuple(tokens.shape)}")
        if masks.shape != tuple(tokens.shape[:2]):
            raise ValueError(f"masks {masks.shape} vs tokens {tuple(tokens.shape)}")
        n = tokens.shape[0]
        with self._mutex:
            row0 = self._rows
            self._ensure_capacity_locked(row0 + n)
            # fp16 is the reference store's host precision: round there
            # first, then to the device dtype
            slab = tokens.to(device=self.device, dtype=torch.float16)
            self._buf[row0 : row0 + n] = slab.to(self.device_dtype)
            self._mask_buf[row0 : row0 + n] = torch.as_tensor(masks, device=self.device)
            self._masks = np.concatenate([self._masks, masks])
            self._rows = row0 + n

    def _ensure_capacity_locked(self, rows: int) -> None:
        cap = 0 if self._buf is None else self._buf.shape[0]
        if rows <= cap:
            return
        new_cap = self._grow_cap(rows)
        wanted = new_cap * self.max_doc_length * self._element_bytes
        if new_cap < rows or wanted > self.device_budget_bytes:
            raise RuntimeError(
                f"token store of {rows} rows exceeds its device budget of "
                f"{self.device_budget_bytes} bytes (TOKEN_STORE_DEVICE_BUDGET_MB); "
                "the host-gather fallback is not ported yet")
        ld, d = self.max_doc_length, self.dim
        buf = torch.zeros((new_cap, ld, d), dtype=self.device_dtype, device=self.device)
        mask_buf = torch.zeros((new_cap, ld), dtype=torch.bool, device=self.device)
        if self._buf is not None:
            buf[: self._rows] = self._buf[: self._rows]
            mask_buf[: self._rows] = self._mask_buf[: self._rows]
        self._buf, self._mask_buf = buf, mask_buf

    # ------------------------------------------------------------- reads
    def _rows_clamped(self, rows: Sequence[int]) -> np.ndarray:
        """Row ids with out-of-range entries (a store swapped for a smaller
        one between the caller's check and this read) mapped to -1, which
        the kernel scores as all-padding so the candidate sinks."""
        rows = np.asarray(list(rows), np.int64)
        return np.where((rows >= 0) & (rows < self._rows), rows, -1)

    def maxsim_fused(self, q_emb, q_mask, rows) -> Optional[torch.Tensor]:
        """Candidate gather + MaxSim in ONE K1 launch → scores [B, n] f32
        on the store's device; None for an empty store."""
        with self._mutex:
            if self._buf is None:
                return None
            return maxsim_gather(
                torch.as_tensor(q_emb, device=self.device), q_mask,
                self._buf, self._mask_buf, self._rows_clamped(rows))

    def gather(self, rows: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (docs [n, Ld, D] doc-major device tensor, masks [n, Ld] bool)."""
        with self._mutex:
            r = torch.as_tensor(self._rows_clamped(rows), device=self.device)
            valid = r >= 0
            safe = torch.where(valid, r, torch.zeros_like(r))
            if self._buf is None:
                raise ValueError("gather from an empty token store")
            return self._buf[safe], self._mask_buf[safe] & valid[:, None]

    # ----------------------------------------------------------- persist
    def save(self, directory: str) -> None:
        """``token_store.npz`` in the JAX package's layout (fp16 tokens)."""
        with self._mutex:
            n = self._rows
            if self._buf is None:
                tokens = np.zeros((0, self.max_doc_length, self.dim), np.float16)
            else:
                tokens = self._buf[:n].to(torch.float16).cpu().numpy()
            arrays = {"tokens": tokens, "masks": self._masks.copy(),
                      "quantize": np.array(self.quantize)}
        path = Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path / "token_store.npz", **arrays)

    @classmethod
    def load(cls, directory: str, dim: int, max_doc_length: int, **kwargs) -> "TokenStore":
        file = Path(directory) / "token_store.npz"
        store = cls(dim=dim, max_doc_length=max_doc_length, **kwargs)
        if not file.exists():
            return store
        arrays = np.load(file)
        saved_quant = str(arrays["quantize"]) if "quantize" in arrays else "none"
        if saved_quant != "none":
            raise NotImplementedError(
                f"saved token store is {saved_quant!r}; only 'none' is ported")
        tokens = np.asarray(arrays["tokens"], np.float16)
        masks = np.asarray(arrays["masks"], bool)
        if tokens.size and tokens.shape[1:] != (max_doc_length, dim):
            raise ValueError(
                f"saved token store is {tokens.shape[1:]}, "
                f"configured geometry is ({max_doc_length}, {dim})")
        if len(masks) != len(tokens):
            raise ValueError(
                f"saved token store is torn: {len(tokens)} rows vs "
                f"{len(masks)} masks")
        if len(tokens):
            store.append(tokens, masks)
        return store
