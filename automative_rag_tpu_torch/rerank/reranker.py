"""Late-interaction (ColBERT-style) reranker (PyTorch port of
``automative_rag_tpu/rerank/reranker.py``).

Functional parity with the reference's ``ColBERTReranker``
(``src/core/query/llm/rerankers.py``): MaxSim late-interaction scoring and
multi-query rerank sharing document encodings (:563-662). The per-document
Python scoring loop of the reference is replaced by the K1 MaxSim kernel
(``ops/maxsim.py``) scoring all candidates for all queries in one launch.
The cross-encoder second scorer of the JAX package is not ported yet.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..documents.schema import Document
from ..models.colbert import ColBERTEncoder
from ..ops.maxsim import maxsim_gather


def _ranked(documents: Sequence[Document], scores: np.ndarray,
            top_k: Optional[int]) -> List[Tuple[Document, float]]:
    ranked = sorted(zip(documents, scores.tolist()), key=lambda p: p[1], reverse=True)
    return ranked[:top_k] if top_k is not None else ranked


class LateInteractionReranker:
    def __init__(self, encoder: ColBERTEncoder):
        self.encoder = encoder
        self.last_timings: dict = {}

    # ------------------------------------------------------------- scoring
    def maxsim_scores_batch(
        self,
        queries: Sequence[str],
        documents: Sequence[Document],
    ) -> np.ndarray:
        """Raw MaxSim scores [n_queries, n_docs]; doc encodings shared across
        queries (reference batch path, rerankers.py:563-662)."""
        t0 = time.perf_counter()
        q_emb, q_mask = self.encoder.encode_queries(list(queries))
        t1 = time.perf_counter()
        d_emb, d_mask = self.encoder.encode_documents([d.page_content for d in documents])
        if d_emb.is_cuda:  # K1 reads bf16 tokens; the CPU path keeps fp16
            d_emb = d_emb.to(torch.bfloat16)
        t2 = time.perf_counter()
        scores = maxsim_gather(
            q_emb, q_mask, d_emb,
            torch.as_tensor(d_mask, device=d_emb.device),
            np.arange(len(documents))).cpu().numpy()
        t3 = time.perf_counter()
        self.last_timings = {
            "encode_query_s": t1 - t0,
            "encode_docs_s": t2 - t1,
            "maxsim_s": t3 - t2,
        }
        return scores

    def maxsim_scores_from_store(
        self,
        queries: Sequence[str],
        rows: Sequence[int],
        store,
    ) -> np.ndarray:
        """MaxSim scores [n_queries, n_rows] against stored token embeddings
        (no document forward passes — see token_store.py): one K1 launch
        gathers the candidate slabs by row id and scores them."""
        t0 = time.perf_counter()
        q_emb, q_mask = self.encoder.encode_queries(list(queries))
        t1 = time.perf_counter()
        scores = store.maxsim_fused(q_emb, q_mask, rows)
        if scores is None:
            raise ValueError("maxsim from an empty token store")
        scores = scores.cpu().numpy()
        self.last_timings = {
            "encode_query_s": t1 - t0,
            "maxsim_s": time.perf_counter() - t1,
            "fused_gather": True,
        }
        return scores

    def rerank_rows_batch(
        self,
        queries: Sequence[str],
        docs_per_query: Sequence[Sequence[Document]],
        rows_per_query: Sequence[Sequence[int]],
        store,
        top_k: Optional[int] = None,
    ) -> List[List[Tuple[Document, float]]]:
        """Batched rerank-from-store with per-query candidate sets in ONE
        MaxSim launch.

        The per-query row sets are unioned: the kernel streams each distinct
        candidate's token slab once and scores it against every query —
        identical device-memory traffic to per-query gathers (the union's
        total bytes bound both), one launch instead of B. Scores for rows a
        query didn't retrieve are computed but discarded (the kernel is
        bandwidth-bound)."""
        if not any(len(d) for d in docs_per_query):
            return [[] for _ in queries]
        union = sorted({int(r) for rows in rows_per_query for r in rows})
        pos_of = {r: i for i, r in enumerate(union)}
        scores = self.maxsim_scores_from_store(list(queries), union, store)
        return [
            _ranked(docs, scores[b, [pos_of[int(r)] for r in rows]], top_k)
            if docs else []
            for b, (docs, rows) in enumerate(zip(docs_per_query, rows_per_query))
        ]

    def rerank_rows(
        self,
        query: str,
        documents: Sequence[Document],
        rows: Sequence[int],
        store,
        top_k: Optional[int] = None,
    ) -> List[Tuple[Document, float]]:
        """rerank() over stored token embeddings."""
        if not documents:
            return []
        return _ranked(documents, self.maxsim_scores_from_store([query], rows, store)[0],
                       top_k)

    # -------------------------------------------------------------- rerank
    def rerank(
        self,
        query: str,
        documents: Sequence[Document],
        top_k: Optional[int] = None,
    ) -> List[Tuple[Document, float]]:
        """MaxSim rerank with the documents encoded on the fly."""
        if not documents:
            return []
        return _ranked(documents, self.maxsim_scores_batch([query], documents)[0], top_k)
