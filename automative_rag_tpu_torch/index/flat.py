"""Flat exact-cosine vector index, device-resident (PyTorch).

Port of ``automative_rag_tpu/index/flat.py``, bf16 (or f32) storage only —
the int8 and int4 slabs are not ported yet. Vectors live as one padded
[capacity, dim] device tensor, metadata lives in the columnar store of
``filters.py``, and a search is

    scores = Q @ Vᵀ  (bf16 operands, f32 accumulation)
    mask   = valid ∧ filter-bitmask
    top-k  = stable-sorted masked scores (lowest index wins ties)

The dense ``[B, D] × [D, N]`` product is a plain ``torch.matmul``: it was
left to XLA in the JAX package (no Pallas kernel). Capacity is padded to a
power-of-two multiple of 128; live upserts/deletes touch host mirrors and
are flushed to the device lazily, with pure appends below a fold
threshold searched on the host until the next restage. The on-disk format
(``arrays.npz`` + ``manifest.json``) is the JAX package's, so a checkpoint
saved by either package loads in the other.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..documents.schema import Document
from ..ops.topk import masked_top_k
from .filters import (
    FilterError,
    FilterSpec,
    MetadataColumns,
    compile_filter,
    eval_filter_mask,
    eval_filter_mask_np,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class SearchResult:
    document: Document
    score: float
    row: int


def _round_capacity(n: int) -> int:
    """Smallest power-of-two ≥ n that is also ≥ 128 (so the padded slab only
    changes shape when the corpus crosses a capacity bucket)."""
    cap = 128
    while cap < n:
        cap *= 2
    return cap


def _search_kernel(vectors, valid, codes, numerics, queries, spec,
                   filtered: bool, k: int):
    """[B, D] @ [N, D]ᵀ with bf16 operands and f32 accumulation (the
    products of bf16 values are exact in f32), masked top-k."""
    scores = torch.matmul(queries.to(vectors.dtype).float(),
                          vectors.float().T)
    mask = valid & eval_filter_mask(codes, numerics, spec) if filtered else valid
    return masked_top_k(scores, mask, k)


class FlatIndex:
    """Exact cosine search over a device-resident corpus."""

    def __init__(self, dim: int, device_dtype: str = "bfloat16", device="cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        name = str(device_dtype)
        if name not in _DTYPES:
            raise NotImplementedError(
                f"device_dtype={name!r}: only bfloat16 and float32 flat "
                "slabs are ported; int8 and int4 are not yet")
        self._dtype_name = name
        self.device_dtype = _DTYPES[name]
        # host mirrors (source of truth). _vectors/_deleted are exact-size
        # VIEWS over geometric-growth buffers, so an append costs O(rows
        # appended) instead of a copy of the whole mirror.
        self._nrows = 0
        self._vec_buf = np.zeros((0, dim), np.float32)
        self._del_buf = np.zeros(0, bool)
        self._docs: List[Document] = []
        self._ids: List[str] = []
        self._row_of_id: Dict[str, int] = {}
        self.columns = MetadataColumns()
        # device cache
        self._device: Optional[dict] = None
        # guards host mirrors + device staging: ingestion and queries may
        # run on different threads
        self._mutex = threading.RLock()

    # ------------------------------------------------------ host mirrors
    @property
    def _vectors(self) -> np.ndarray:
        return self._vec_buf[: self._nrows]

    @_vectors.setter
    def _vectors(self, arr: np.ndarray) -> None:
        # wholesale replacement (load): the new array IS the buffer; _nrows
        # follows it. Callers replace _deleted right after.
        arr = np.asarray(arr, np.float32)
        self._vec_buf = arr
        self._nrows = arr.shape[0]

    @property
    def _deleted(self) -> np.ndarray:
        return self._del_buf[: self._nrows]

    @_deleted.setter
    def _deleted(self, arr: np.ndarray) -> None:
        arr = np.asarray(arr, bool)
        if arr.shape[0] != self._nrows:
            raise ValueError(
                f"deleted mask rows {arr.shape[0]} != vector rows "
                f"{self._nrows} (set _vectors first)")
        self._del_buf = arr

    def _ensure_host_capacity(self, n: int) -> None:
        """Grow the host buffers to hold ≥ n rows (1.5× geometric, so a
        10M-row mirror doesn't round up to 2× host RAM like pow2 would).
        Always leaves ≥12.5% slack past n: a bulk add sized exactly to the
        corpus would otherwise make the FIRST later append pay the full
        regrowth copy (4 GB at 1M×1024 — the bench measured exactly that)."""
        cap = self._vec_buf.shape[0]
        if cap >= n:
            return
        new_cap = max(n + n // 8, (cap * 3) // 2, 1024)
        vec = np.empty((new_cap, self.dim), np.float32)
        vec[: self._nrows] = self._vec_buf[: self._nrows]
        dele = np.zeros(new_cap, bool)
        dele[: self._nrows] = self._del_buf[: self._nrows]
        self._vec_buf, self._del_buf = vec, dele

    # ------------------------------------------------------------------ size
    @property
    def count(self) -> int:
        return int((~self._deleted).sum())

    @property
    def total_rows(self) -> int:
        return len(self._ids)

    # ------------------------------------------------------------ mutation
    def add(
        self,
        vectors: np.ndarray,
        documents: Sequence[Document],
        normalize: bool = True,
    ) -> List[str]:
        """Upsert documents with their embedding vectors.

        Vectors are L2-normalized so dot product == cosine similarity
        (parity with the reference's cosine-distance collection,
        ``vectorstore.py:60-87``).
        """
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected vectors [N, {self.dim}], got {vectors.shape}")
        if len(documents) != vectors.shape[0]:
            raise ValueError("documents/vectors length mismatch")
        if normalize:
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = vectors / np.maximum(norms, 1e-12)

        for doc in documents:
            doc.stamp_ingestion()

        with self._mutex:
            state = self._device
            start = len(self._ids)
            n_new = len(documents)
            capacity = _round_capacity(start + n_new)

            self._ensure_host_capacity(start + n_new)
            self._vec_buf[start : start + n_new] = vectors
            self._del_buf[start : start + n_new] = False
            self._nrows = start + n_new
            self.columns.append_rows([d.metadata for d in documents], capacity)
            new_ids = [doc.id for doc in documents]
            upserted = False
            # bulk-ingest fast path: per-doc dict/append calls cost ~100 µs
            # each in Python — 2 min of pure bookkeeping at 1M rows
            if not any(did in self._row_of_id for did in new_ids) \
                    and len(set(new_ids)) == len(new_ids):
                self._ids.extend(new_ids)
                self._docs.extend(documents)
                self._row_of_id.update(
                    zip(new_ids, range(start, start + n_new)))
            else:
                for i, doc in enumerate(documents):
                    row = start + i
                    if doc.id in self._row_of_id:
                        # upsert: tombstone the previous row
                        self._deleted[self._row_of_id[doc.id]] = True
                        upserted = True
                    self._row_of_id[doc.id] = row
                    self._ids.append(doc.id)
                    self._docs.append(doc)
            self._device = None
            if (
                state is not None
                and not upserted
                and start + n_new - state.get("staged_rows", 0)
                <= self._tail_fold_threshold(state)
            ):
                # pure append under the fold threshold: keep the staged slab
                # resident (restaging is a full host→device transfer of the
                # corpus — ~2 GB at 1M×1024 bf16); rows ≥ staged_rows are
                # searched on the host until the tail folds. An upsert
                # tombstones a STAGED row, whose stale validity would
                # resurrect it — that path restages.
                self._device = state
        return new_ids

    @staticmethod
    def _tail_fold_threshold(state: dict) -> int:
        """Host-searched tail budget before the next search restages: 1% of
        the staged corpus, floor 1024 rows — the host exact scan at that
        size costs less than the restage it defers."""
        return max(1024, state.get("staged_rows", 0) // 100)

    # ------------------------------------------------------------- device
    def _device_state(self) -> dict:
        with self._mutex:
            return self._device_state_locked()

    def _device_state_locked(self) -> dict:
        if self._device is not None:
            return self._device
        n = len(self._ids)
        capacity = _round_capacity(max(n, 1))
        vectors = np.zeros((capacity, self.dim), np.float32)
        vectors[:n] = self._vectors
        valid = np.zeros(capacity, bool)
        valid[:n] = ~self._deleted
        self.columns._grow(capacity)
        dev = self.device
        self._device = {
            "valid": torch.as_tensor(valid, device=dev),
            "codes": torch.as_tensor(self.columns.codes[:, :capacity], device=dev),
            "numerics": torch.as_tensor(self.columns.numerics[:, :capacity],
                                        device=dev),
            "vectors": torch.as_tensor(vectors, device=dev).to(self.device_dtype),
            "capacity": capacity,
            "staged_rows": n,  # rows the slab covers; later appends are
            # host-searched (see add / _host_tail_top_k) until folded
        }
        return self._device

    # -------------------------------------------------------------- search
    def _compile(self, metadata_filter: Optional[Dict[str, Any]]) -> Tuple[FilterSpec, bool]:
        """Compile the filter; on error, fall back to match-all (reference
        falls back to unfiltered search on filter errors,
        ``vectorstore.py:195-213``)."""
        if not metadata_filter:
            return FilterSpec.match_all(self.device), True
        try:
            return compile_filter(metadata_filter, self.columns, self.device), True
        except FilterError:
            return FilterSpec.match_all(self.device), False

    def _host_tail_top_k(self, queries: np.ndarray, spec, k: int,
                         start: int):
        """Exact top-k over host-only rows [start, n) — the appends since
        the device slab was staged. Small by construction (``add`` folds
        the tail past ``_tail_fold_threshold``), so a numpy dot beats
        restaging the corpus. Returns (vals, rows) padded to k, or None."""
        with self._mutex:
            n = len(self._ids)
            if n <= start:
                return None
            vecs = np.array(self._vectors[start:n], np.float32)
            valid = ~self._deleted[start:n]
            codes = np.array(self.columns.codes[:, start:n])
            numerics = np.array(self.columns.numerics[:, start:n])
        mask = valid & eval_filter_mask_np(codes, numerics, spec)
        scores = queries.astype(np.float32) @ vecs.T
        scores = np.where(mask[None, :], scores, -np.inf)
        k_t = min(k, scores.shape[1])
        idx = np.argpartition(-scores, k_t - 1, axis=1)[:, :k_t]
        vals = np.take_along_axis(scores, idx, axis=1)
        order = np.argsort(-vals, axis=1)
        vals = np.take_along_axis(vals, order, axis=1)
        rows = (np.take_along_axis(idx, order, axis=1) + start).astype(np.int64)
        rows = np.where(np.isfinite(vals), rows, -1)
        if k_t < k:
            pad = ((0, 0), (0, k - k_t))
            vals = np.pad(vals, pad, constant_values=-np.inf)
            rows = np.pad(rows, pad, constant_values=-1)
        return vals, rows

    def _hits_from(self, values: np.ndarray, indices: np.ndarray
                   ) -> List[List[SearchResult]]:
        """Result lists without the ``-inf`` / out-of-range padding slots."""
        with self._mutex:
            docs = self._docs
            n = len(docs)
        out: List[List[SearchResult]] = []
        for b in range(values.shape[0]):
            hits = []
            for score, row in zip(values[b], indices[b]):
                row = int(row)
                if not np.isfinite(score) or not 0 <= row < n:
                    continue
                hits.append(SearchResult(docs[row], float(score), row))
            out.append(hits)
        return out

    @staticmethod
    def _merge_host_tail(values, indices, tail, k: int):
        all_vals = np.concatenate([values, tail[0]], axis=1)
        all_rows = np.concatenate([indices.astype(np.int64), tail[1]], axis=1)
        order = np.argsort(-all_vals, axis=1)[:, :k]
        return (np.take_along_axis(all_vals, order, axis=1),
                np.take_along_axis(all_rows, order, axis=1))

    def search(
        self,
        queries: np.ndarray,
        k: int,
        metadata_filter: Optional[Dict[str, Any]] = None,
        normalize: bool = True,
    ) -> List[List[SearchResult]]:
        """Batched filtered cosine top-k. Returns per-query result lists."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if normalize:
            norms = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(norms, 1e-12)

        spec, ok = self._compile(metadata_filter)
        filtered = bool(metadata_filter) and ok
        q_dev = torch.as_tensor(queries, device=self.device)
        state = self._device_state()
        k_eff = min(k, state["capacity"])
        values, indices = _search_kernel(
            state["vectors"], state["valid"], state["codes"],
            state["numerics"], q_dev, spec, filtered, k_eff)
        values = values.cpu().numpy()
        indices = indices.cpu().numpy()
        tail = self._host_tail_top_k(queries, spec, k_eff, state["staged_rows"])
        if tail is not None:
            values, indices = self._merge_host_tail(values, indices, tail, k_eff)
        return self._hits_from(values, indices)

    def rows_match(self, rows: Sequence[int],
                   metadata_filter: Optional[Dict[str, Any]] = None
                   ) -> np.ndarray:
        """Host-side tombstone + filter check for an explicit small row set
        (the sparse arm post-filters its lexical top-k through this instead
        of coupling to the device filter state)."""
        rows = np.asarray(list(rows), np.int64)
        if len(rows) == 0:
            return np.zeros(0, bool)
        spec, ok_spec = self._compile(metadata_filter)
        if metadata_filter and not ok_spec:
            return np.zeros(len(rows), bool)
        with self._mutex:
            # out-of-range rows are simply not live
            in_range = rows < len(self._deleted)
            safe = np.where(in_range, rows, 0)
            ok = in_range & ~self._deleted[safe]
            if metadata_filter:
                codes = np.array(self.columns.codes[:, safe])
                numerics = np.array(self.columns.numerics[:, safe])
                ok &= eval_filter_mask_np(codes, numerics, spec)
        return ok

    def host_scores(self, rows: Sequence[int], query_vec: np.ndarray
                    ) -> np.ndarray:
        """Cosine scores for an explicit row set against one query vector
        (stored vectors are unit-normalized at add time). Out-of-range rows
        score 0."""
        rows = np.asarray(list(rows), np.int64)
        if len(rows) == 0:
            return np.zeros(0, np.float32)
        with self._mutex:
            n = self._vectors.shape[0]
            in_range = (rows >= 0) & (rows < n)
            vecs = self._vectors[np.where(in_range, rows, 0)]
        scores = (vecs @ np.asarray(query_vec, np.float32)).astype(np.float32)
        return np.where(in_range, scores, 0.0).astype(np.float32)

    def documents_at(self, rows: Sequence[int]) -> List[Optional[Document]]:
        """Docs for an explicit row set under one lock; ``None`` for
        out-of-range rows (callers drop those)."""
        with self._mutex:
            docs = self._docs
            n = len(docs)
        return [docs[int(r)] if 0 <= int(r) < n else None for r in rows]

    # --------------------------------------------------------- checkpoint
    def save(self, directory: str) -> None:
        """Serialize the index (the reference has no index checkpoint — Qdrant
        owns persistence; here the device index is a first-class artifact)."""
        path = Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        with self._mutex:
            # snapshot under the mutex: the app lock already serializes the
            # product path, but a direct-library caller saving during an
            # add would otherwise capture vectors/columns/docs at different
            # lengths — a torn checkpoint that misaligns on load
            n = len(self._ids)
            vectors = np.array(self._vectors[:n])
            deleted = np.array(self._deleted[:n])
            codes = np.array(self.columns.codes[:, :n])
            numerics = np.array(self.columns.numerics[:, :n])
            ids = list(self._ids)
            docs = [d.to_dict() for d in self._docs]
            vocabs = {k: dict(v) for k, v in self.columns.vocabs.items()}
        np.savez_compressed(
            path / "arrays.npz",
            vectors=vectors,
            deleted=deleted,
            codes=codes,
            numerics=numerics,
        )
        manifest = {
            "version": 1,
            "dim": self.dim,
            "device_dtype": self._dtype_name,
            "saved_at": time.time(),
            "ids": ids,
            "docs": docs,
            "vocabs": vocabs,
            "count": n,
        }
        (path / "manifest.json").write_text(
            json.dumps(manifest, ensure_ascii=False), encoding="utf-8"
        )

    @classmethod
    def load(cls, directory: str, device="cuda") -> "FlatIndex":
        path = Path(directory)
        manifest = json.loads((path / "manifest.json").read_text(encoding="utf-8"))
        arrays = np.load(path / "arrays.npz", allow_pickle=False)
        index = cls(dim=manifest["dim"], device_dtype=manifest["device_dtype"],
                    device=device)
        n = manifest["count"]
        index._vectors = np.asarray(arrays["vectors"], np.float32)
        index._deleted = np.asarray(arrays["deleted"], bool)
        index._ids = list(manifest["ids"])
        index._docs = [Document.from_dict(d) for d in manifest["docs"]]
        index._row_of_id = {
            doc_id: row
            for row, doc_id in enumerate(index._ids)
            if not index._deleted[row]
        }
        cols = MetadataColumns()
        cols.vocabs = {k: {kk: int(vv) for kk, vv in v.items()} for k, v in manifest["vocabs"].items()}
        capacity = _round_capacity(max(n, 1))
        cols._grow(capacity)
        cols.codes[:, :n] = np.asarray(arrays["codes"], np.int32)
        cols.numerics[:, :n] = np.asarray(arrays["numerics"], np.int32)
        cols.count = n
        index.columns = cols
        return index
