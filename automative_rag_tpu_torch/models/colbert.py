"""ColBERT-style token-level encoder for late-interaction reranking.

Port of ``automative_rag_tpu/models/colbert.py``: queries tokenize to a
fixed 32 tokens, documents to 256, and the last hidden state provides
token-level embeddings. Returns embeddings (fp16 tensors on the encoder's
device — fp16 is the JAX package's fetch dtype, so both round at the same
point) plus *scoring masks* (host numpy):

- query mask: content tokens only — [CLS]/[SEP]/[PAD] are excluded;
- doc mask: real tokens only — padded doc tokens are excluded from the max.

The int8 encode paths and the device-append path are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from .encoder import EncoderConfig, build_encoder, load_flax_params
from .tokenizer import load_tokenizer


class ColBERTEncoder:
    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        weights_path: str = "",
        tokenizer_path: str = "",
        max_query_length: int = 32,
        max_doc_length: int = 256,
        batch_size: int = 128,
        seed: int = 1,
        device="cuda",
    ):
        self.config = config or EncoderConfig.bge_m3()
        self.device = resolve_device(device)
        self.max_query_length = max_query_length
        self.max_doc_length = max_doc_length
        self.batch_size = batch_size
        self.model, self.pretrained = build_encoder(
            self.config, self.device, weights_path, seed)
        self.tokenizer = load_tokenizer(tokenizer_path, vocab_size=self.config.vocab_size)

    def load_flax_params(self, params) -> "ColBERTEncoder":
        """Replace the weights with a Flax parameter tree (numpy arrays)."""
        self.model.load_state_dict(load_flax_params(self.config, params))
        return self

    @property
    def dim(self) -> int:
        return self.config.hidden_size

    @torch.no_grad()
    def _encode(self, texts: Sequence[str], max_length: int
                ) -> Tuple[torch.Tensor, np.ndarray]:
        ids, mask = self.tokenizer.encode_batch(texts, max_length)
        # length bucketing: forward at the smallest 32-multiple covering the
        # longest real sequence, pad back to max_length with zeros (already
        # mask-False)
        real = int(np.asarray(mask).sum(axis=1).max()) if len(texts) else 0
        bucket = min(max_length, max(32, -(-real // 32) * 32))
        ids_b = torch.as_tensor(ids[:, :bucket], device=self.device)
        mask_b = torch.as_tensor(mask[:, :bucket], device=self.device)
        emb = torch.zeros((len(texts), max_length, self.dim), dtype=torch.float16,
                          device=self.device)
        for i in range(0, len(texts), self.batch_size):
            hidden = self.model(ids_b[i : i + self.batch_size],
                                mask_b[i : i + self.batch_size])
            emb[i : i + self.batch_size, :bucket] = hidden.to(torch.float16)
        return emb, mask

    def encode_queries(self, queries: Sequence[str]) -> Tuple[torch.Tensor, np.ndarray]:
        """→ (embeddings [B, Lq, H] fp16 tensor, scoring mask [B, Lq] bool).

        The scoring mask keeps content tokens: attention minus the leading
        [CLS] and the final [SEP] of each sequence."""
        emb, mask = self._encode(queries, self.max_query_length)
        scoring = mask.astype(bool).copy()
        scoring[:, 0] = False  # [CLS]
        lengths = mask.sum(axis=1)
        for b, length in enumerate(lengths):
            if length > 1:
                scoring[b, length - 1] = False  # [SEP]
        return emb, scoring

    def encode_documents(self, texts: Sequence[str]) -> Tuple[torch.Tensor, np.ndarray]:
        """→ (embeddings [N, Ld, H] fp16 tensor, real-token mask [N, Ld] bool)."""
        emb, mask = self._encode(texts, self.max_doc_length)
        return emb, mask.astype(bool)
