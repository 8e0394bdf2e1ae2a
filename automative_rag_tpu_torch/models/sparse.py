"""bge-m3 sparse (lexical) term-weight encoder.

bge-m3 is a three-headed model — dense (CLS), sparse (per-token lexical
weights), and multi-vector (ColBERT). The reference deploys only the dense
head + ColBERT rerank (``src/core/query/embeddings.py`` via
FlagEmbedding's dense output); this module adds the third head so the
framework covers the flagship encoder's full capability: exact lexical
matching for spec codes, trims and model designations that dense vectors
blur (e.g. "xDrive40i" vs "xDrive30d").

Two modes, mirroring ``DenseEmbedder``:

- **transformer**: the real bge-m3 sparse head — ``relu(W·h_t + b)`` per
  token position, term weight = max over positions carrying that token id
  (the bge-m3 aggregation), special tokens excluded. The head weights load
  from ``sparse_linear.pt`` / ``sparse_linear.safetensors`` next to the
  encoder checkpoint when present.
- **lexical** (weightless fallback): sqrt-tf term weights over the shared
  tokenizer's unigrams + hashed bigrams. IDF is applied at query time by
  the retrieval engine from live corpus statistics (``SparseIndex.idf``)
  so rare exact terms dominate — functional BM25-class retrieval with no
  weights at all.

Output contract (both modes): fixed-width padded term lists —
``(ids[int32, T], weights[float32, T])`` with pad id ``-1`` — static
shapes for the device scoring kernel in ``index/sparse.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import CLS_ID, PAD_ID, SEP_ID

#: document/query pad term id — never equals a real token id (ids ≥ 0)
SPARSE_PAD = -1

#: multiplier folding adjacent-token bigrams into a disjoint id space
#: (phrase identity for CJK, where the hash tokenizer splits per char)
_BIGRAM_MIX = 1000003


def _load_sparse_head(weights_path: str) -> Optional[Tuple[np.ndarray, float]]:
    """Load the bge-m3 sparse-head linear (hidden → 1) if shipped next to
    the encoder checkpoint. Returns (w[hidden], bias) or None."""
    if not weights_path:
        return None
    root = Path(weights_path)
    if not root.is_dir():
        return None
    st = root / "sparse_linear.safetensors"
    if st.exists():
        from safetensors.numpy import load_file

        tensors = load_file(str(st))
        for key in ("sparse_linear.weight", "weight"):
            if key in tensors:
                w = np.asarray(tensors[key], np.float32).reshape(-1)
                b = float(np.asarray(tensors.get(
                    key.replace("weight", "bias"), 0.0)).reshape(()))
                return w, b
        return None
    pt = root / "sparse_linear.pt"
    if pt.exists():
        import torch

        state = torch.load(str(pt), map_location="cpu", weights_only=True)
        for key in ("linear.weight", "weight", "sparse_linear.weight"):
            if key in state:
                w = state[key].float().numpy().reshape(-1)
                bkey = key.replace("weight", "bias")
                b = float(state[bkey].float().numpy().reshape(())) if bkey in state else 0.0
                return w, b
    return None


class SparseEncoder:
    """Term-list encoder sharing the dense embedder's tokenizer (and, in
    transformer mode, its encoder — one copy of the model on the device)."""

    def __init__(
        self,
        dense,  # DenseEmbedder — shared tokenizer/params/forward
        top_terms: int = 48,
        query_terms: int = 32,
        bigrams: bool = True,
    ):
        self.dense = dense
        self.tokenizer = dense.tokenizer
        self.top_terms = int(top_terms)
        self.query_terms = int(query_terms)
        self.bigrams = bigrams
        self.max_length = dense.max_length
        vocab = getattr(self.tokenizer, "vocab_size", 0) or 0
        self._bigram_base = max(vocab, 1)

        head = None
        if getattr(dense, "pretrained", False):
            head = _load_sparse_head(getattr(dense, "weights_path", "") or "")
        self._head = head
        self.mode = "transformer" if head is not None else "lexical"
        #: lexical weights are uncalibrated tf — the engine folds in
        #: corpus idf; learned transformer weights already encode term
        #: importance, so idf would double-count
        self.use_idf = self.mode == "lexical"
        self._token_weights_fn = None  # built lazily in transformer mode

    # ------------------------------------------------------------ helpers
    def _special_ids(self) -> Tuple[int, ...]:
        tok = self.tokenizer
        ids = [
            getattr(tok, "pad_token_id", PAD_ID),
            getattr(tok, "cls_token_id", CLS_ID),
            getattr(tok, "sep_token_id", SEP_ID),
        ]
        return tuple(i for i in ids if i is not None)

    def _pad(self, ids: List[int], weights: List[float], width: int
             ) -> Tuple[np.ndarray, np.ndarray]:
        out_ids = np.full(width, SPARSE_PAD, np.int32)
        out_w = np.zeros(width, np.float32)
        if ids:
            order = np.argsort(np.asarray(weights))[::-1][:width]
            kept_ids = np.asarray(ids, np.int64)[order]
            kept_w = np.asarray(weights, np.float32)[order]
            out_ids[: len(order)] = kept_ids.astype(np.int32)
            out_w[: len(order)] = kept_w
        return out_ids, out_w

    # ------------------------------------------------------------ lexical
    def _lexical_terms(self, text: str) -> Tuple[List[int], List[float]]:
        ids, mask = self.tokenizer.encode_batch([text], self.max_length)
        return self._lexical_terms_row(ids[0], mask[0])

    def _lexical_terms_row(self, ids, mask) -> Tuple[List[int], List[float]]:
        specials = set(self._special_ids())
        toks = [int(t) for t, m in zip(ids, mask) if m and int(t) not in specials]
        tf: dict = {}
        for t in toks:
            tf[t] = tf.get(t, 0) + 1
        if self.bigrams:
            base = self._bigram_base
            for a, b in zip(toks, toks[1:]):
                bid = base + (a * _BIGRAM_MIX + b) % base
                # bigram terms carry 0.49× unigram weight after sqrt
                tf[bid] = tf.get(bid, 0) + 0.49
        term_ids = list(tf.keys())
        weights = [float(np.sqrt(tf[t])) for t in term_ids]
        return term_ids, weights

    # -------------------------------------------------------- transformer
    def _transformer_terms(self, texts: Sequence[str]
                           ) -> List[Tuple[List[int], List[float]]]:
        import torch

        if self._token_weights_fn is None:
            w_vec, bias = self._head
            device = self.dense.device
            w_dev = torch.as_tensor(w_vec, dtype=torch.float32, device=device)

            @torch.no_grad()
            def _weights(input_ids, attention_mask):
                hidden = self.dense.hidden_states(input_ids, attention_mask)
                logits = hidden @ w_dev + bias
                mask = torch.as_tensor(attention_mask, device=device)
                return torch.relu(logits) * mask

            self._token_weights_fn = _weights

        bs = max(int(getattr(self.dense, "batch_size", 32)), 1)
        ids_parts, w_parts = [], []
        for i in range(0, len(texts), bs):
            part_ids, part_mask = self.tokenizer.encode_batch(
                list(texts[i: i + bs]), self.max_length)
            ids_parts.append(part_ids)
            w_parts.append(
                self._token_weights_fn(part_ids, part_mask)
                .float().cpu().numpy())
        ids = np.concatenate(ids_parts)
        token_w = np.concatenate(w_parts)
        specials = set(self._special_ids())
        out = []
        for row_ids, row_w in zip(ids, token_w):
            agg: dict = {}
            for t, w in zip(row_ids, row_w):
                t = int(t)
                if w <= 0.0 or t in specials:
                    continue
                # bge-m3 aggregation: max over repeated occurrences
                if w > agg.get(t, 0.0):
                    agg[t] = float(w)
            out.append((list(agg.keys()), list(agg.values())))
        return out

    # ------------------------------------------------------------- public
    def encode_documents(self, texts: Sequence[str]
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids [n, top_terms] int32, weights [n, top_terms] f32)."""
        n = len(texts)
        ids = np.full((n, self.top_terms), SPARSE_PAD, np.int32)
        weights = np.zeros((n, self.top_terms), np.float32)
        if self.mode == "transformer":
            per_text = self._transformer_terms(texts)
        else:
            # one tokenizer pass for the whole batch (ingest hot path)
            tok_ids, tok_mask = self.tokenizer.encode_batch(
                list(texts), self.max_length)
            per_text = [
                self._lexical_terms_row(r, m)
                for r, m in zip(tok_ids, tok_mask)
            ]
        for i, (t_ids, t_w) in enumerate(per_text):
            ids[i], weights[i] = self._pad(t_ids, t_w, self.top_terms)
        return ids, weights

    def encode_query(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids [query_terms] int32, weights [query_terms] f32)."""
        if self.mode == "transformer":
            t_ids, t_w = self._transformer_terms([text])[0]
        else:
            t_ids, t_w = self._lexical_terms(text)
        return self._pad(t_ids, t_w, self.query_terms)
