"""The retrieval engine: encode → ANN top-k → bitmask filter → MaxSim
rerank → token-budget trim (PyTorch port of
``automative_rag_tpu/engine/retrieval.py``, the per-stage path).

Rerank is a first-class stage:

    query ──► DenseEmbedder ──► index.search(retrieval_k, filter bitmask)
          ──► LateInteractionReranker.rerank(final_k)
          ──► mode-aware token-budget trim ──► (doc, score) list

Depths and cutoffs come from the per-mode table (``config.mode_config``).
The JAX package's one-dispatch fused search (``engine/fused.py``) engages
only for a budget-mode IVF index, never for the flat index, and is not
ported: every query runs the per-stage path.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config.mode_config import QueryMode, mode_config, trim_documents_by_tokens
from ..documents.schema import Document
from ..index.flat import SearchResult
from ..models.bge_m3 import DenseEmbedder
from ..rerank.reranker import LateInteractionReranker
from ..utils.quality import expand_query_synonyms


def _minmax(scores: np.ndarray) -> np.ndarray:
    scores = np.asarray(scores, np.float64)
    lo, hi = scores.min(), scores.max()
    if hi > lo:
        return (scores - lo) / (hi - lo)
    return np.ones_like(scores)


def _normalize_ranked(
    ranked: List[Tuple[Document, float]]
) -> List[Tuple[Document, float]]:
    """MaxSim/hybrid scores are unbounded; normalize into [0.35, 1] — ABOVE
    the per-mode relevance cutoffs (0.2-0.3): reranked candidates are
    already MaxSim-screened, and a floor inside the cutoff band silently
    killed the lowest-scoring candidate on every query (fatal when a
    selective filter leaves only 2). This makes the cutoffs intentionally
    inert for RERANKED results — they still apply to the rerank-off path,
    whose raw cosine scores can dip below them. Shared by the single and
    batch paths so their scoring can never diverge."""
    if not ranked:
        return ranked
    scores = np.array([s for _, s in ranked], np.float64)
    lo, hi = scores.min(), scores.max()
    if hi > lo:
        norm = 0.35 + 0.65 * (scores - lo) / (hi - lo)
    else:
        norm = np.ones_like(scores)
    return [(doc, float(n)) for (doc, _), n in zip(ranked, norm)]


#: additive bonus (on the [0.35, 1]-normalized rerank score) when a
#: candidate's metadata exactly matches the entity the query names. The
#: model bonus exceeds the normalization range on purpose: when the user
#: literally names a model, its own documents outrank every other model's
#: (what a hard-filtered search would return) while keeping their rerank
#: order among themselves — decisive for short CJK model names (汉, 唐)
#: whose single token carries ~1/30 of a MaxSim score, and for telling 汉
#: apart from 汉EV. The manufacturer signal is weaker (many models share
#: one brand) so it only nudges. The bonus exists for ORDERING only — after
#: sorting, scores are re-normalized into [0.35, 1] so callers (API/UI
#: present them cosine-like) never see values above 1.
_ENTITY_BONUS = {"model": 1.0, "manufacturer": 0.15}


def _apply_entity_bonus(
    ranked: List[Tuple[Document, float]], detected: Dict[str, Any]
) -> List[Tuple[Document, float]]:
    key, val = next(iter(detected.items()))
    bonus = _ENTITY_BONUS[key]
    return [
        (d, s + bonus if d.metadata.get(key) == val else s) for d, s in ranked
    ]


def _query_entities(query: str) -> Optional[Dict[str, Any]]:
    """Detect a filterable model/manufacturer named in the query via the
    shared boundary-aware matcher (ingestion/metadata.find_query_entities —
    same catalogs the payload index is built from, so detection and the
    index always agree; boundary rules keep G6 from matching inside G63
    and 唐 inside 唐山). Used for entity-guided candidate expansion: short
    CJK model names (汉, 唐) carry almost no dense-vector signal, so the
    true document can miss the top-k entirely — a hard metadata match is
    the reliable recall path for them."""
    from ..ingestion.metadata import find_query_entities

    detected = find_query_entities(query)
    if "model" in detected:
        return {"model": detected["model"]}
    if "manufacturer" in detected:
        return {"manufacturer": detected["manufacturer"]}
    return None


class RetrievalEngine:
    #: extra hard-filtered candidates unioned in when the query names a
    #: known model/manufacturer and no explicit filter was given
    ENTITY_EXPAND_K = 5

    def __init__(
        self,
        embedder: DenseEmbedder,
        index,
        reranker: Optional[LateInteractionReranker] = None,
        token_store=None,
        entity_expansion: bool = True,
        sparse_index=None,
        sparse_encoder=None,
        sparse_k: int = 10,
        sparse_weight: float = 0.3,
        sparse_rerank_weight: float = 0.2,
        cache_size: int = 256,
    ):
        self.embedder = embedder
        self.index = index
        self.reranker = reranker
        self.token_store = token_store
        self.entity_expansion = entity_expansion
        # bge-m3 sparse arm: lexical top-k unioned into the candidate set
        # (exact-term recall; models/sparse.py). sparse_weight governs the
        # rerank-OFF fusion; sparse_rerank_weight folds the lexical score
        # into the reranked combine too (bge-m3 hybrid: dense/sparse/
        # multi-vector weighted sum) so exact-term matches can lift
        # near-duplicate trims the contextual MaxSim blurs.
        self.sparse_index = sparse_index
        self.sparse_encoder = sparse_encoder
        self.sparse_k = sparse_k
        self.sparse_weight = sparse_weight
        self.sparse_rerank_weight = sparse_rerank_weight
        self.last_timings: Dict[str, float] = {}
        # repeated-query retrieval cache (reference has none; analytics
        # show the same canonical questions recur). Entries carry a STATE
        # FINGERPRINT instead of relying on invalidation calls: any
        # mutation that can change ranking — ingest, an upsert, a new
        # index, store or encoder object, a changed sparse weight — shifts
        # the fingerprint and the entry just misses. 0 disables.
        self.cache_size = cache_size
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self.cache_stats = {"hits": 0, "misses": 0}

    def _state_fingerprint(self) -> tuple:
        idx = self.index
        sp = self.sparse_index
        return (
            id(idx), idx.total_rows, idx.count,
            None if sp is None else (id(sp), sp.rows),
            self.sparse_k, self.sparse_weight, self.sparse_rerank_weight,
            id(self.reranker), id(self.embedder),
            None if self.token_store is None else (
                id(self.token_store), self.token_store.rows),
        )

    def _cache_get(self, key: tuple, fingerprint: tuple):
        if not self.cache_size:
            return None
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is not None and hit[0] == fingerprint:
                self._cache.move_to_end(key)
                self.cache_stats["hits"] += 1
                return list(hit[1])
            self.cache_stats["misses"] += 1
            if hit is not None:
                del self._cache[key]  # stale fingerprint
        return None

    def _cache_put(self, key: tuple, fingerprint: tuple, value) -> None:
        if not self.cache_size:
            return
        with self._cache_lock:
            self._cache[key] = (fingerprint, list(value))
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)

    # ------------------------------------------------------------ ingest
    def add_documents(self, documents: List[Document]) -> List[str]:
        texts = [d.page_content for d in documents]
        vectors = self.embedder.embed_texts(texts)
        ids = self.index.add(vectors, documents)
        if self.token_store is not None and self.reranker is not None:
            # token embeddings row-aligned with the index (rerank-from-store);
            # they stay on the device from the encoder into the store
            token_embs, masks = self.reranker.encoder.encode_documents(texts)
            self.token_store.append(token_embs, masks)
        if self.sparse_index is not None and self.sparse_encoder is not None:
            # sparse term rows, row-aligned with the index (same pairing
            # invariant as the token store — callers hold the app lock)
            term_ids, term_w = self.sparse_encoder.encode_documents(texts)
            self.sparse_index.append(term_ids, term_w)
        return ids

    # -------------------------------------------------------- sparse arm
    def _sparse_union(
        self,
        query: str,
        qvec: np.ndarray,
        hits: List[SearchResult],
        metadata_filter: Optional[Dict[str, Any]],
    ):
        """Union the lexical top-k into the dense candidate set. Returns
        ``(hits, q_terms, n_extra)`` — q_terms ``(ids, weights)`` for fusion
        scoring, or None when the arm is inactive. The lexical candidates are
        post-filtered on the host (tombstones + metadata) through
        ``index.rows_match`` so the arm never couples to the device filter
        state; unioned hits carry their host cosine as the dense score."""
        if not self._sparse_active():
            return hits, None, 0
        q_ids, q_w = self._sparse_terms(query)
        # slack above sparse_k so tombstoned/filtered rows don't starve it
        cand = self.sparse_index.search(q_ids, q_w, k=self.sparse_k + 8)
        hits, n_extra = self._sparse_merge(qvec, hits, metadata_filter, cand)
        return hits, (q_ids, q_w), n_extra

    def _sparse_active(self) -> bool:
        sp, enc = self.sparse_index, self.sparse_encoder
        if sp is None or enc is None or sp.rows == 0:
            return False
        if (
            sp.rows != self.index.total_rows
            or not hasattr(self.index, "rows_match")
            or not hasattr(self.index, "host_scores")
        ):
            # misaligned rows (should be impossible — appends are paired)
            # or an index kind without the host helpers: disengage rather
            # than risk returning the wrong documents
            return False
        return True

    def _sparse_terms(self, query: str):
        sp, enc = self.sparse_index, self.sparse_encoder
        q_ids, q_w = enc.encode_query(query)
        if enc.use_idf:
            q_w = q_w * sp.idf(q_ids)
        return q_ids, q_w

    def _sparse_merge(self, qvec, hits, metadata_filter, cand):
        """Union lexical candidates into the dense hit list (host-filtered
        through ``index.rows_match``; unioned hits carry their host cosine
        as the dense score)."""
        extra = []
        if cand:
            rows = [r for r, _ in cand]
            ok = self.index.rows_match(rows, metadata_filter)
            seen = {h.row for h in hits}
            extra = [r for r, o in zip(rows, ok) if o and r not in seen]
            extra = extra[: self.sparse_k]
            if extra:
                dense_scores = self.index.host_scores(extra, qvec)
                docs_for = self.index.documents_at(extra)
                hits = list(hits) + [
                    SearchResult(d, float(s), r)
                    for r, s, d in zip(extra, dense_scores, docs_for)
                    if d is not None  # out-of-range row
                ]
        return hits, len(extra)

    def _fuse_scores(
        self, hits: List[SearchResult], q_terms
    ) -> List[Tuple[Document, float]]:
        """Rerank-off scoring: min-max-normalized weighted sum of the dense
        and sparse arms over the candidate union (the reference's 0.8/0.2
        min-max combine idiom, ``rerankers.py:302-333``, applied to
        dense+sparse instead of ColBERT+cross-encoder)."""
        dense = np.array([h.score for h in hits], np.float64)
        sparse = self.sparse_index.score_rows([h.row for h in hits], *q_terms)
        w = self.sparse_weight
        fused = (1.0 - w) * _minmax(dense) + w * _minmax(sparse)
        ranked = sorted(
            zip((h.document for h in hits), fused), key=lambda x: -x[1]
        )
        return [(d, float(s)) for d, s in ranked]

    def _blend_sparse(
        self,
        ranked: List[Tuple[Document, float]],
        q_terms,
        row_by_doc_id: Dict[str, int],
    ) -> List[Tuple[Document, float]]:
        """Fold the lexical arm into a NORMALIZED reranked list: the
        multi-vector (MaxSim) score carries (1−w), the min-max-normalized
        sparse match w (``sparse_rerank_weight``). Docs the union didn't
        cover keep sparse score 0 after min-max, so the blend only ever
        promotes lexical evidence."""
        w = self.sparse_rerank_weight
        if (not ranked or q_terms is None or w <= 0.0
                or self.sparse_index is None):
            return ranked
        rows = [row_by_doc_id.get(doc.id, -1) for doc, _ in ranked]
        # a row missing from the sparse table skips the blend (ordering
        # falls back to pure rerank — correct, unboosted)
        if any(r < 0 or r >= self.sparse_index.rows for r in rows):
            return ranked
        sparse = self.sparse_index.score_rows(rows, *q_terms)
        blended = (1.0 - w) * np.array([s for _, s in ranked], np.float64) \
            + w * _minmax(sparse)
        return [(doc, float(s)) for (doc, _), s in zip(ranked, blended)]

    # ----------------------------------------------------------- retrieve
    def retrieve(
        self,
        query: str,
        mode: QueryMode | str = QueryMode.FACTS,
        metadata_filter: Optional[Dict[str, Any]] = None,
        retrieval_k: Optional[int] = None,
        final_k: Optional[int] = None,
        rerank: bool = True,
    ) -> List[Tuple[Document, float]]:
        """Full retrieval pipeline; returns (doc, score) sorted descending.

        Scores are cosine similarities when rerank is off, hybrid/MaxSim
        scores when on (reference contract: tests/test_retrieval.py:191-327
        — retrieve → rerank on/off → format)."""
        mode = QueryMode.parse(mode)
        params = mode_config.get_retrieval_params(mode)
        k1 = retrieval_k or params["retrieval_k"]
        k2 = final_k or params["final_k"]

        import json as _json

        cache_key = (query, mode.value,
                     _json.dumps(metadata_filter, sort_keys=True,
                                 ensure_ascii=False, default=str),
                     k1, k2, bool(rerank))
        fingerprint = self._state_fingerprint()
        cached = self._cache_get(cache_key, fingerprint)
        if cached is not None:
            self.last_timings = {"cached": True, "retrieval_k": k1,
                                 "final_k": k2}
            return cached

        t0 = time.perf_counter()
        # canonical-synonym expansion (功率→马力 …) feeds the exact-term
        # consumers: the sparse arm (lexical bridge from colloquial
        # phrasing to spec-sheet docs) and the reranker (extra query
        # tokens can only add MaxSim evidence). The DENSE vector keeps the
        # user's words — appending terms the target doc may not contain
        # dilutes its cosine below the mode relevance_cutoff.
        exp_query = expand_query_synonyms(query)
        qvec = self.embedder.embed_query(query)
        t1 = time.perf_counter()
        # entity-guided expansion filter: when the query names a known
        # model or brand and the caller didn't filter, union in a few
        # hard-filtered hits so the entity's own documents are guaranteed
        # a rerank slot; wrong detections only add candidates, which
        # rerank screens out
        detected = None
        if self.entity_expansion and metadata_filter is None:
            detected = _query_entities(query)

        hits = self.index.search(
            np.asarray(qvec), k1, metadata_filter)[0]
        if detected:
            seen_rows = {h.row for h in hits}
            extra = self.index.search(
                np.asarray(qvec), self.ENTITY_EXPAND_K, detected
            )[0]
            hits = hits + [h for h in extra if h.row not in seen_rows]
        t2 = time.perf_counter()
        hits, q_terms, n_sparse = self._sparse_union(
            exp_query, np.asarray(qvec), hits, metadata_filter)
        t2s = time.perf_counter()

        candidates = [h.document for h in hits]
        if rerank and self.reranker is not None and candidates:
            rows = [h.row for h in hits]
            # rerank the FULL candidate set (not top_k): the entity bonus
            # below must be able to lift a hard-filtered candidate into the
            # final k
            if self.token_store is not None and max(rows) < self.token_store.rows:
                ranked = self.reranker.rerank_rows(
                    exp_query, candidates, rows, self.token_store, top_k=None
                )
            else:
                ranked = self.reranker.rerank(
                    exp_query, candidates, top_k=None)
            if ranked:
                ranked = _normalize_ranked(ranked)
                ranked = self._blend_sparse(
                    ranked, q_terms, {h.document.id: h.row for h in hits})
                if detected:
                    ranked = _apply_entity_bonus(ranked, detected)
                ranked = sorted(ranked, key=lambda x: -x[1])[:k2]
                if detected:
                    # bonus can push scores past 1; keep the bonus ORDER but
                    # re-map the returned scores into the documented range
                    ranked = _normalize_ranked(ranked)
        elif q_terms is not None and hits:
            # no rerank stage: fuse the two arms' scores over the union
            ranked = self._fuse_scores(hits, q_terms)[:k2]
        else:
            ranked = [(h.document, h.score) for h in hits[:k2]]
        t3 = time.perf_counter()

        trimmed = trim_documents_by_tokens(ranked, mode)
        self.last_timings = {
            "embed_s": t1 - t0,
            "search_s": t2 - t1,
            "rerank_s": t3 - t2s,
            "retrieval_k": k1,
            "final_k": k2,
            "candidates": len(candidates),
        }
        if q_terms is not None:
            self.last_timings["sparse_s"] = t2s - t2
            self.last_timings["sparse_candidates"] = n_sparse
        self._cache_put(cache_key, fingerprint, trimmed)
        return trimmed

    def retrieve_batch(
        self,
        queries: List[str],
        mode: QueryMode | str = QueryMode.FACTS,
        metadata_filter: Optional[Dict[str, Any]] = None,
        metadata_filters: Optional[List[Optional[Dict[str, Any]]]] = None,
        retrieval_k: Optional[int] = None,
        final_k: Optional[int] = None,
        rerank: bool = True,
    ) -> List[List[Tuple[Document, float]]]:
        """Batched retrieval: one encoder forward, one search launch per
        distinct filter group, ONE sparse scan and ONE MaxSim launch for
        the whole batch. This is the serving-throughput path — per-query
        cost amortizes every matmul over the batch.

        ``metadata_filters`` (per-query) overrides ``metadata_filter``
        (shared); queries sharing a filter share a search launch."""
        if not queries:
            return []
        mode = QueryMode.parse(mode)
        params = mode_config.get_retrieval_params(mode)
        k1 = retrieval_k or params["retrieval_k"]
        k2 = final_k or params["final_k"]

        t0 = time.perf_counter()
        # same canonical-synonym expansion as the single-query path
        # (sparse arm + reranker only; the dense vectors keep user words)
        exp_queries = [expand_query_synonyms(q) for q in queries]
        qvecs = self.embedder.embed_texts(queries)
        t1 = time.perf_counter()
        import json as _json

        if metadata_filters is not None:
            # group queries by filter so each distinct filter is one launch
            per_query_hits: List[Any] = [None] * len(queries)
            groups: Dict[str, Tuple[Optional[Dict[str, Any]], List[int]]] = {}
            for i, flt in enumerate(metadata_filters):
                key = _json.dumps(flt, sort_keys=True, ensure_ascii=False)
                groups.setdefault(key, (flt, []))[1].append(i)
            for flt, rows in groups.values():
                hits = self.index.search(qvecs[rows], k1, flt)
                for i, h in zip(rows, hits):
                    per_query_hits[i] = h
        else:
            per_query_hits = list(self.index.search(qvecs, k1, metadata_filter))

        # entity-guided expansion, same semantics as the single-query path;
        # queries naming the same entity share one extra filtered launch
        detected_per_query: List[Optional[Dict[str, Any]]] = [None] * len(queries)
        if self.entity_expansion:
            effective = (
                metadata_filters if metadata_filters is not None
                else [metadata_filter] * len(queries)
            )
            expand_groups: Dict[str, Tuple[Dict[str, Any], List[int]]] = {}
            for i, flt in enumerate(effective):
                if flt is not None:
                    continue
                det = _query_entities(queries[i])
                if det:
                    detected_per_query[i] = det
                    key = _json.dumps(det, sort_keys=True, ensure_ascii=False)
                    expand_groups.setdefault(key, (det, []))[1].append(i)
            for det, idxs in expand_groups.values():
                extra_hits = self.index.search(
                    qvecs[idxs], self.ENTITY_EXPAND_K, det
                )
                for i, extra in zip(idxs, extra_hits):
                    seen = {h.row for h in per_query_hits[i]}
                    per_query_hits[i] = list(per_query_hits[i]) + [
                        h for h in extra if h.row not in seen
                    ]

        # sparse lexical arm, same semantics as the single-query path but
        # ONE batched device dispatch for the whole query set
        q_terms_per_query: List[Optional[Tuple]] = [None] * len(queries)
        n_sparse = 0
        if self._sparse_active():
            terms = [self._sparse_terms(q) for q in exp_queries]
            cand_b = self.sparse_index.search_batch(
                np.stack([t[0] for t in terms]),
                np.stack([t[1] for t in terms]),
                k=self.sparse_k + 8,
            )
            for i in range(len(queries)):
                flt = (metadata_filters[i] if metadata_filters is not None
                       else metadata_filter)
                per_query_hits[i], n = self._sparse_merge(
                    qvecs[i], per_query_hits[i], flt, cand_b[i])
                q_terms_per_query[i] = terms[i]
                n_sparse += n
        t2 = time.perf_counter()

        docs_per_query = [[h.document for h in hits] for hits in per_query_hits]
        rows_per_query = [[h.row for h in hits] for hits in per_query_hits]
        all_rows = [r for rows in rows_per_query for r in rows]

        if (
            rerank
            and self.reranker is not None
            and any(docs_per_query)
            and self.token_store is not None
            and all_rows
            and max(all_rows) < self.token_store.rows
        ):
            ranked_per_query = self.reranker.rerank_rows_batch(
                exp_queries, docs_per_query, rows_per_query,
                self.token_store, top_k=None,
            )
        elif rerank and self.reranker is not None and any(docs_per_query):
            # no token store coverage: per-query encode-and-rerank fallback
            ranked_per_query = [
                self.reranker.rerank(q, docs, top_k=None) if docs else []
                for q, docs in zip(exp_queries, docs_per_query)
            ]
        else:
            ranked_per_query = [
                (self._fuse_scores(hits, qt)[:k2] if qt is not None and hits
                 else [(h.document, h.score) for h in hits[:k2]])
                for hits, qt in zip(per_query_hits, q_terms_per_query)
            ]
            rerank = False

        out: List[List[Tuple[Document, float]]] = []
        for i, ranked in enumerate(ranked_per_query):
            if rerank and ranked:
                ranked = _normalize_ranked(ranked)
                ranked = self._blend_sparse(
                    ranked, q_terms_per_query[i],
                    {h.document.id: h.row for h in per_query_hits[i]})
                if detected_per_query[i]:
                    ranked = _apply_entity_bonus(ranked, detected_per_query[i])
                ranked = sorted(ranked, key=lambda x: -x[1])[:k2]
                if detected_per_query[i]:
                    ranked = _normalize_ranked(ranked)  # see _ENTITY_BONUS
            out.append(trim_documents_by_tokens(ranked, mode))
        self.last_timings = {
            "embed_s": t1 - t0,
            "search_s": t2 - t1,
            "rerank_s": time.perf_counter() - t2,
            "batch": len(queries),
            "retrieval_k": k1,
            "final_k": k2,
        }
        return out
