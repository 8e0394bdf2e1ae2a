"""Dense embedder (bge-m3-compatible): encode texts → normalized vectors.

Port of ``automative_rag_tpu/models/bge_m3.py``. Dense embedding for bge-m3
is CLS pooling + L2 normalization. Batches are padded to fixed length
buckets (the same buckets as the JAX package, so both pad alike).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..backend import resolve_device
from .encoder import EncoderConfig, TransformerEncoder, build_encoder, load_flax_params
from .tokenizer import load_tokenizer

_LENGTH_BUCKETS = (32, 64, 128, 256, 512)
_BIGRAM_MIX = 1000003
_U32 = 0xFFFFFFFF


def _bucket_length(max_len: int, cap: int) -> int:
    for b in _LENGTH_BUCKETS:
        if b >= max_len:
            return min(b, cap)
    return cap


def lexical_embed(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """Hashed bag-of-tokens + token-bigrams: bucket = hash % dim,
    sign-hashed, sqrt-tf weighted, L2 normalized. The reference hashes in
    wrapping uint32; here int64 masked to 32 bits gives the same hashes."""
    ids = input_ids.long()
    mask = attention_mask.float()

    def bag(hashes, weights):
        bucket = hashes % dim
        sign = torch.where((hashes // dim) % 2 == 0, 1.0, -1.0)
        out = torch.zeros((ids.shape[0], dim), dtype=torch.float32, device=ids.device)
        return out.scatter_add_(1, bucket, sign * weights)

    counts = bag(ids, mask)
    bi = (ids[:, :-1] * _BIGRAM_MIX + ids[:, 1:]) & _U32
    bi_mask = mask[:, :-1] * mask[:, 1:]
    counts = counts + 0.7 * bag(bi, bi_mask)
    emb = torch.sign(counts) * torch.sqrt(torch.abs(counts))  # sqrt-tf
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-12)


class DenseEmbedder:
    """Batched dense text embedder.

    Two modes:
    - **transformer** (a checkpoint is configured, or asked for): encoder
      forward, CLS pooling, L2 norm.
    - **lexical** (weightless fallback): deterministic hashed bag-of-tokens
      projection — cosine then measures lexical overlap.
    """

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        weights_path: str = "",
        tokenizer_path: str = "",
        max_length: int = 512,
        batch_size: int = 64,
        seed: int = 0,
        mode: Optional[str] = None,  # "transformer" | "lexical" | None=auto
        device="cuda",
    ):
        self.config = config or EncoderConfig.bge_m3()
        self.device = resolve_device(device)
        self.max_length = max_length
        self.batch_size = batch_size
        self.weights_path = weights_path
        self.model: Optional[TransformerEncoder] = None
        self.pretrained = False
        if weights_path:
            model, pretrained = build_encoder(self.config, self.device, weights_path, seed)
            if pretrained:
                self.model, self.pretrained = model, True
        self.mode = mode or ("transformer" if self.pretrained else "lexical")
        if self.model is None and self.mode == "transformer":
            # lexical mode never touches the transformer: the full-size
            # random init only happens when transformer mode is asked for
            self.model, _ = build_encoder(self.config, self.device, "", seed)
        self.tokenizer = load_tokenizer(tokenizer_path, vocab_size=self.config.vocab_size)

    @classmethod
    def from_flax_params(cls, config: EncoderConfig, params, tokenizer_path: str = "",
                         max_length: int = 512, batch_size: int = 64,
                         device="cuda") -> "DenseEmbedder":
        """Transformer-mode embedder around a Flax parameter tree."""
        embedder = cls(config=config, tokenizer_path=tokenizer_path,
                       max_length=max_length, batch_size=batch_size,
                       mode="lexical", device=device)
        embedder.model = TransformerEncoder(config, device=embedder.device)
        embedder.model.load_state_dict(load_flax_params(config, params))
        embedder.mode = "transformer"
        embedder.pretrained = True
        return embedder

    @property
    def dim(self) -> int:
        return self.config.hidden_size

    def hidden_states(self, input_ids, attention_mask) -> torch.Tensor:
        """Last hidden state [B, L, H] f32 on the embedder's device."""
        return self.model(input_ids, attention_mask)

    @torch.no_grad()
    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Embed up to batch_size texts (single forward)."""
        ids, mask = self.tokenizer.encode_batch(texts, self.max_length)
        real_len = int(mask.sum(axis=1).max()) if len(texts) else 1
        length = _bucket_length(real_len, self.max_length)
        ids_t = torch.as_tensor(ids[:, :length], device=self.device)
        mask_t = torch.as_tensor(mask[:, :length], device=self.device)
        if self.mode == "lexical":
            out = lexical_embed(ids_t, mask_t, self.dim)
        else:
            cls_vec = self.model(ids_t, mask_t)[:, 0, :]  # bge-m3 dense = CLS
            norm = torch.linalg.vector_norm(cls_vec, dim=-1, keepdim=True)
            out = cls_vec / torch.clamp(norm, min=1e-12)
        return out.float().cpu().numpy()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Embed any number of texts, batching internally."""
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.concatenate([
            self.embed_batch(list(texts[i : i + self.batch_size]))
            for i in range(0, len(texts), self.batch_size)
        ], axis=0)

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]
