"""Sparse (lexical) term index — the retrieval arm for bge-m3's sparse head
(PyTorch port of ``automative_rag_tpu/index/sparse.py``).

Row-aligned with the main vector index (appends are paired under the app
lock, like the ColBERT token store): row *r* here holds the top-T weighted
terms of the document in row *r* of the dense index. The retrieval engine
unions this index's top-k into the dense candidate set before rerank.

Scoring one query against the corpus is a padded equality-match reduction

    score[n] = Σ_t Σ_q [doc_ids[n,t] == q_ids[q]] · doc_w[n,t] · q_w[q]

over a TERM-MAJOR device slab [T, cap] (int32 ids, bf16 weights). On the
card the scan is the K3/K3b CUDA kernel (``ops/sparse_scan.py``); on the
CPU its plain version. Masking to the staged row count and the two-stage
top-k run in PyTorch. Column capacity pads to a block multiple, term lists
pad with id −1 / weight 0 (zero weight ⇒ zero contribution).

Live appends follow the flat index's staged-slab pattern: the built device
slab survives appends, fresh rows score on the host (numpy over ≤ a few
thousand × T terms) and fold into the slab once the tail outgrows its
threshold. The ``pallas_lut`` and ``pallas16`` scan variants of the JAX
package are not ported yet.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..ops.sparse_scan import sparse_scores_tm_batch
from ..ops.topk import hierarchical_top_k

#: rows per scan block; capacity pads to a multiple of this
_BLOCK = 8192
#: appended-tail size that triggers folding the tail into the device slab
_TAIL_FOLD = 4096

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _sparse_topk(ids_t, weights_t, n_rows: int, q_ids: np.ndarray,
                 q_w: np.ndarray, k: int):
    """ids_t [T, cap] int32, weights_t [T, cap], q_ids/q_w [B, Q] →
    (values [B, k], rows [B, k]) as numpy; cap % _BLOCK == 0."""
    scores = sparse_scores_tm_batch(ids_t, weights_t, q_ids, q_w)
    cap = ids_t.shape[1]
    live = torch.arange(cap, device=scores.device) < n_rows
    scores = torch.where(live[None, :], scores,
                         torch.full((), float("-inf"), device=scores.device))
    values, rows = hierarchical_top_k(scores, k, block=_BLOCK)
    return values.cpu().numpy(), rows.cpu().numpy()


def _score_rows_np(ids: np.ndarray, weights: np.ndarray,
                   q_ids: np.ndarray, q_w: np.ndarray) -> np.ndarray:
    """Host oracle / tail scorer: same reduction in numpy."""
    match = ids[:, :, None] == q_ids[None, None, :]
    return (match * weights[:, :, None] * q_w[None, None, :]).sum((1, 2))


class SparseIndex:
    """Device-scannable padded term lists + live document-frequency stats."""

    def __init__(self, top_terms: int = 48, device_dtype: str = "bfloat16",
                 device="cuda"):
        self.top_terms = int(top_terms)
        if str(device_dtype) not in _DTYPES:
            raise NotImplementedError(f"sparse slab dtype {device_dtype!r}")
        self.device_dtype = _DTYPES[str(device_dtype)]
        self._dtype_name = str(device_dtype)
        self.device = resolve_device(device)
        self._ids = np.zeros((0, self.top_terms), np.int32)
        self._weights = np.zeros((0, self.top_terms), np.float32)
        self._df: Dict[int, int] = {}
        # device cache: (ids_slab [T, cap], weights_slab [T, cap], staged)
        self._device: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None
        self._mutex = threading.RLock()

    # ------------------------------------------------------------- size
    @property
    def rows(self) -> int:
        return self._ids.shape[0]

    # --------------------------------------------------------- mutation
    def append(self, ids: np.ndarray, weights: np.ndarray) -> None:
        ids = np.asarray(ids, np.int32)
        weights = np.asarray(weights, np.float32)
        if ids.ndim != 2 or ids.shape[1] != self.top_terms:
            raise ValueError(
                f"expected [n, {self.top_terms}] term ids, got {ids.shape}")
        with self._mutex:
            self._ids = np.concatenate([self._ids, ids])
            self._weights = np.concatenate([self._weights, weights])
            # terms are unique within a row (encoder aggregates per id), so
            # document frequency = bulk counts over the non-pad ids
            terms, counts = np.unique(ids[ids >= 0], return_counts=True)
            for t, c in zip(terms.tolist(), counts.tolist()):
                self._df[t] = self._df.get(t, 0) + c
            # the built slab survives: fresh rows score on the host until
            # the tail outgrows the fold threshold
            if self._device is not None:
                staged = self._device[2]
                if self.rows - staged > _TAIL_FOLD:
                    self._device = None

    def select_rows(self, rows: Sequence[int]) -> None:
        """Compaction hook: keep (reordered) ``rows``, row-aligned with the
        main index's live order; recomputes df."""
        rows = np.asarray(list(rows), np.int64)
        with self._mutex:
            self._ids = self._ids[rows]
            self._weights = self._weights[rows]
            self._recount_df_locked()
            self._device = None

    def _recount_df_locked(self) -> None:
        terms, counts = np.unique(self._ids[self._ids >= 0], return_counts=True)
        self._df = dict(zip(terms.tolist(), counts.tolist()))

    # ------------------------------------------------------------ scoring
    def idf(self, q_ids: np.ndarray) -> np.ndarray:
        """BM25-style idf for query terms, from live corpus stats
        (weightless/lexical mode only — learned sparse weights already
        encode term importance)."""
        n = max(self.rows, 1)
        out = np.zeros(len(q_ids), np.float32)
        for i, t in enumerate(np.asarray(q_ids)):
            t = int(t)
            if t < 0:
                continue
            df = self._df.get(t, 0)
            out[i] = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        return out

    def _device_state(self):
        with self._mutex:
            if self._device is None and self.rows:
                cap = max(_BLOCK, -(-self.rows // _BLOCK) * _BLOCK)
                ids = np.full((self.top_terms, cap), -1, np.int32)
                ids[:, : self.rows] = self._ids.T
                w = np.zeros((self.top_terms, cap), np.float32)
                w[:, : self.rows] = self._weights.T
                self._device = (
                    torch.as_tensor(ids, device=self.device),
                    torch.as_tensor(w, device=self.device).to(self.device_dtype),
                    self.rows,
                )
            return self._device

    @staticmethod
    def _trim_query_width(q_ids: np.ndarray, q_w: np.ndarray):
        """Compact valid terms forward and round the query width up to a
        power-of-two bucket (min 8). Scan cost is LINEAR in the query width
        and the encoder pads to a fixed 32/64, while real queries carry
        ~5-16 terms — bucketing cuts the compare work up to 4x for typical
        traffic without touching scores (pad / zero-weight terms contribute
        exactly 0). Accepts [Q] or [B, Q]; batches share the max bucket."""
        q_ids = np.atleast_2d(np.asarray(q_ids, np.int32))
        q_w = np.atleast_2d(np.asarray(q_w, np.float32))
        b, q = q_ids.shape
        valid = (q_ids >= 0) & (q_w != 0.0)
        counts = valid.sum(axis=1)
        need = max(1, int(counts.max()) if b else 1)
        bucket = 8
        while bucket < need:
            bucket *= 2
        bucket = min(bucket, q)
        out_ids = np.full((b, bucket), -1, np.int32)
        out_w = np.zeros((b, bucket), np.float32)
        for row in range(b):
            n = int(counts[row])
            take = min(n, bucket)
            out_ids[row, :take] = q_ids[row, valid[row]][:take]
            out_w[row, :take] = q_w[row, valid[row]][:take]
        return out_ids, out_w

    def _device_topk_batch(self, state, q_ids: np.ndarray,
                           q_w: np.ndarray, k: int):
        """Device top-k over the staged slab for [B, Q] queries."""
        ids_slab, w_slab, staged = state
        q_ids, q_w = self._trim_query_width(q_ids, q_w)
        return _sparse_topk(ids_slab, w_slab, staged, q_ids, q_w, k)

    def search(self, q_ids: np.ndarray, q_w: np.ndarray, k: int
               ) -> List[Tuple[int, float]]:
        """Top-k (row, score) by lexical match score; scores ≤ 0 dropped
        (no term overlap means the row is noise, not a candidate)."""
        if self.rows == 0 or k <= 0:
            return []
        state = self._device_state()
        q_ids = np.asarray(q_ids, np.int32)
        q_w = np.asarray(q_w, np.float32)
        k_eff = min(k, self.rows)
        staged = state[2]
        values, rows = self._device_topk_batch(
            state, q_ids, q_w, min(k_eff, staged))
        values, rows = values[0], rows[0]
        with self._mutex:
            tail_start = staged
            tail_ids = self._ids[tail_start:]
            tail_w = self._weights[tail_start:]
        if len(tail_ids):
            tail_scores = _score_rows_np(tail_ids, tail_w, q_ids, q_w)
            values = np.concatenate([values, tail_scores])
            rows = np.concatenate(
                [rows, np.arange(tail_start, tail_start + len(tail_ids))])
            order = np.argsort(-values)[:k_eff]
            values, rows = values[order], rows[order]
        return [
            (int(r), float(v)) for v, r in zip(values, rows) if v > 0.0
        ]

    def search_batch(self, q_ids: np.ndarray, q_w: np.ndarray, k: int
                     ) -> List[List[Tuple[int, float]]]:
        """Batched ``search``: q_ids/q_w [B, Q] (fixed query width, pad id
        −1 / weight 0) → per-query top-k (row, score) lists, one device
        dispatch for the whole batch. Tail rows merge per query on the
        host, same as the single-query path."""
        q_ids = np.asarray(q_ids, np.int32)
        q_w = np.asarray(q_w, np.float32)
        b = q_ids.shape[0]
        if self.rows == 0 or k <= 0 or b == 0:
            return [[] for _ in range(b)]
        state = self._device_state()
        staged = state[2]
        k_eff = min(k, self.rows)
        values, rows = self._device_topk_batch(
            state, q_ids, q_w, min(k_eff, staged))
        with self._mutex:
            tail_ids = self._ids[staged:]
            tail_w = self._weights[staged:]
        out: List[List[Tuple[int, float]]] = []
        for i in range(b):
            v, r = values[i], rows[i]
            if len(tail_ids):
                tail_scores = _score_rows_np(
                    tail_ids, tail_w, q_ids[i], q_w[i])
                v = np.concatenate([v, tail_scores])
                r = np.concatenate(
                    [r, np.arange(staged, staged + len(tail_ids))])
                order = np.argsort(-v)[:k_eff]
                v, r = v[order], r[order]
            out.append([
                (int(rr), float(vv)) for vv, rr in zip(v, r) if vv > 0.0
            ])
        return out

    def score_rows(self, rows: Sequence[int], q_ids: np.ndarray,
                   q_w: np.ndarray) -> np.ndarray:
        """Host-side scores for a small explicit row set (fusion path).
        Out-of-range rows score 0 (no lexical evidence) instead of
        crashing the query."""
        rows = np.asarray(list(rows), np.int64)
        if len(rows) == 0:
            return np.zeros(0, np.float32)
        with self._mutex:
            n = self._ids.shape[0]
            in_range = (rows >= 0) & (rows < n)
            safe = np.where(in_range, rows, 0)
            ids = self._ids[safe]
            w = self._weights[safe]
        scores = _score_rows_np(
            ids, w, np.asarray(q_ids, np.int32), np.asarray(q_w, np.float32))
        return np.where(in_range, scores, 0.0).astype(np.float32)

    def save(self, directory: str) -> None:
        path = Path(directory)
        path.mkdir(parents=True, exist_ok=True)
        with self._mutex:
            np.savez(
                path / "sparse.npz",
                ids=self._ids,
                weights=self._weights,
            )
            meta = {"top_terms": self.top_terms,
                    "device_dtype": self._dtype_name}
            (path / "sparse_meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, directory: str, top_terms: int = 48,
             device_dtype: str = "bfloat16", device="cuda") -> "SparseIndex":
        path = Path(directory)
        meta_file = path / "sparse_meta.json"
        if meta_file.exists():
            meta = json.loads(meta_file.read_text())
            top_terms = int(meta.get("top_terms", top_terms))
            device_dtype = meta.get("device_dtype", device_dtype)
        out = cls(top_terms=top_terms, device_dtype=device_dtype, device=device)
        data_file = path / "sparse.npz"
        if data_file.exists():
            data = np.load(data_file)
            out._ids = np.asarray(data["ids"], np.int32)
            out._weights = np.asarray(data["weights"], np.float32)
            out._recount_df_locked()
        return out
