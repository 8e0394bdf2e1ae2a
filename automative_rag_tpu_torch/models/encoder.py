"""XLM-RoBERTa-family transformer encoder in PyTorch — the bge-m3 dense
embedder and the ColBERT token encoder both run this architecture.

Port of ``automative_rag_tpu/models/encoder.py`` (Flax). The rounding
points follow the Flax module: embeddings, projections and the MLP compute
in ``config.dtype`` (bf16 by default), every LayerNorm in f32, the
attention bias is ``-1e9`` cast to the compute dtype, softmax runs in f32,
GELU is exact. Attention is written as the JAX code writes it (matmul,
softmax, matmul). Linear and embedding weights are stored in the compute
dtype (the Flax module casts its f32 params at every use, which rounds the
same way), LayerNorm params in f32.

Weights come from a local HuggingFace safetensors checkpoint
(``load_hf_weights``), from a Flax parameter tree (``load_flax_params``,
numpy arrays; a Flax ``Dense`` kernel is [in, out], a torch ``Linear``
weight [out, in]), or from a seeded random init.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..backend import resolve_device


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 8194
    type_vocab_size: int = 1
    pad_token_id: int = 1  # XLM-R convention; HashTokenizer remaps via mask
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16

    @classmethod
    def bge_m3(cls) -> "EncoderConfig":
        """bge-m3 = XLM-RoBERTa-large geometry, 8192-token positions."""
        return cls(vocab_size=250002, hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096, max_position=8194)

    @classmethod
    def tiny(cls, vocab_size: int = 1024, hidden_size: int = 64) -> "EncoderConfig":
        """Small config for tests and weightless smoke runs."""
        return cls(vocab_size=vocab_size, hidden_size=hidden_size, num_layers=2,
                   num_heads=4, intermediate_size=2 * hidden_size, max_position=514)


class _Linear(nn.Module):
    """Dense layer computing in the weight's dtype (input cast on the way in)."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class _LayerNorm(nn.Module):
    """LayerNorm in f32 whatever the input dtype (Flax ``dtype=float32``)."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device), requires_grad=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, device):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.query = _Linear(h, h, cfg.dtype, device)
        self.key = _Linear(h, h, cfg.dtype, device)
        self.value = _Linear(h, h, cfg.dtype, device)
        self.output = _Linear(h, h, cfg.dtype, device)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, length, _ = hidden.shape
        split = lambda x: x.view(b, length, self.num_heads, self.head_dim).transpose(1, 2)
        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.head_dim)
        scores = scores + bias  # [B, 1, 1, L] additive mask
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        context = torch.matmul(probs, v).transpose(1, 2).reshape(b, length, -1)
        return self.output(context)


class _Layer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device):
        super().__init__()
        self.attention = _SelfAttention(cfg, device)
        self.attention_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.intermediate = _Linear(cfg.hidden_size, cfg.intermediate_size, cfg.dtype, device)
        self.mlp_output = _Linear(cfg.intermediate_size, cfg.hidden_size, cfg.dtype, device)
        self.output_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        hidden = self.attention_norm(hidden + self.attention(hidden, bias))
        mlp = F.gelu(self.intermediate(hidden), approximate="none")
        return self.output_norm(hidden + self.mlp_output(mlp))


class TransformerEncoder(nn.Module):
    """Returns the last hidden state [B, L, H] (f32)."""

    def __init__(self, config: EncoderConfig, device="cuda"):
        super().__init__()
        cfg = self.config = config
        dev = resolve_device(device)
        emb = lambda n: nn.Parameter(
            torch.empty(n, cfg.hidden_size, dtype=cfg.dtype, device=dev),
            requires_grad=False)
        self.word_embeddings = emb(cfg.vocab_size)
        self.position_embeddings = emb(cfg.max_position)
        self.token_type_embeddings = emb(cfg.type_vocab_size)
        self.embeddings_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dev)
        self.layers = nn.ModuleList(_Layer(cfg, dev) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "TransformerEncoder":
        """Seeded random init: embeddings N(0, 1/hidden), dense kernels
        truncated-normal with variance 1/fan_in (the Flax defaults' scales),
        biases 0, LayerNorms identity. Samples in f32, then casts."""
        device = self.word_embeddings.device
        gen = torch.Generator(device=device).manual_seed(int(seed))
        std = 1.0 / math.sqrt(self.config.hidden_size)
        for p in (self.word_embeddings, self.position_embeddings,
                  self.token_type_embeddings):
            p.copy_(torch.empty(p.shape, device=device).normal_(0.0, std, generator=gen))
        for m in self.modules():
            if isinstance(m, _Linear):
                s = 1.0 / math.sqrt(m.weight.shape[1])
                w = torch.empty(m.weight.shape, device=device)
                nn.init.trunc_normal_(w, 0.0, s, -2 * s, 2 * s, generator=gen)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, _LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    @torch.no_grad()
    def forward(self, input_ids, attention_mask) -> torch.Tensor:
        cfg = self.config
        dev = self.word_embeddings.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        mask = torch.as_tensor(attention_mask, device=dev).long()
        # RoBERTa-style position ids: pad positions pinned at pad_token_id,
        # real tokens numbered from pad_token_id + 1
        positions = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        positions = positions.clamp(max=cfg.max_position - 1)
        hidden = (self.word_embeddings[ids] + self.position_embeddings[positions])
        hidden = hidden + self.token_type_embeddings[torch.zeros_like(ids)]
        hidden = self.embeddings_norm(hidden).to(cfg.dtype)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(cfg.dtype)
        for layer in self.layers:
            hidden = layer(hidden, bias)
        return hidden.float()


# --------------------------------------------------------------------------
# Parameter loading: Flax trees and HuggingFace checkpoints
# --------------------------------------------------------------------------

def _flax_key_map(num_layers: int) -> Dict[str, str]:
    """Flax param path ('/'-joined) → this module's state-dict key."""
    mapping = {
        "word_embeddings/embedding": "word_embeddings",
        "position_embeddings/embedding": "position_embeddings",
        "token_type_embeddings/embedding": "token_type_embeddings",
        "embeddings_norm/scale": "embeddings_norm.weight",
        "embeddings_norm/bias": "embeddings_norm.bias",
    }
    for i in range(num_layers):
        fx, pt = f"layer_{i}", f"layers.{i}"
        for proj in ("query", "key", "value", "output"):
            mapping[f"{fx}/attention/{proj}/kernel"] = f"{pt}.attention.{proj}.weight"
            mapping[f"{fx}/attention/{proj}/bias"] = f"{pt}.attention.{proj}.bias"
        for name in ("intermediate", "mlp_output"):
            mapping[f"{fx}/{name}/kernel"] = f"{pt}.{name}.weight"
            mapping[f"{fx}/{name}/bias"] = f"{pt}.{name}.bias"
        for name in ("attention_norm", "output_norm"):
            mapping[f"{fx}/{name}/scale"] = f"{pt}.{name}.weight"
            mapping[f"{fx}/{name}/bias"] = f"{pt}.{name}.bias"
    return mapping


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def load_flax_params(config: EncoderConfig, params) -> Dict[str, torch.Tensor]:
    """Turn a Flax ``TransformerEncoder`` parameter tree (nested mapping of
    numpy arrays) into this module's ``state_dict`` (f32 CPU tensors; the
    module casts on ``load_state_dict``)."""
    flat = _flatten(params)
    state: Dict[str, torch.Tensor] = {}
    for flax_path, key in _flax_key_map(config.num_layers).items():
        if flax_path not in flat:
            raise KeyError(f"Flax params lack {flax_path!r}")
        value = np.asarray(flat[flax_path], np.float32)
        if flax_path.endswith("kernel"):
            value = value.T  # Flax Dense [in, out] → torch Linear [out, in]
        state[key] = torch.tensor(np.ascontiguousarray(value))
    return state


def _hf_key_map(num_layers: int) -> Dict[str, str]:
    """HF XLM-R/BERT state-dict name → this module's state-dict key."""
    mapping = {
        "embeddings.word_embeddings.weight": "word_embeddings",
        "embeddings.position_embeddings.weight": "position_embeddings",
        "embeddings.token_type_embeddings.weight": "token_type_embeddings",
        "embeddings.LayerNorm.weight": "embeddings_norm.weight",
        "embeddings.LayerNorm.bias": "embeddings_norm.bias",
    }
    for i in range(num_layers):
        hf, pt = f"encoder.layer.{i}", f"layers.{i}"
        for proj in ("query", "key", "value"):
            mapping[f"{hf}.attention.self.{proj}.weight"] = f"{pt}.attention.{proj}.weight"
            mapping[f"{hf}.attention.self.{proj}.bias"] = f"{pt}.attention.{proj}.bias"
        mapping[f"{hf}.attention.output.dense.weight"] = f"{pt}.attention.output.weight"
        mapping[f"{hf}.attention.output.dense.bias"] = f"{pt}.attention.output.bias"
        mapping[f"{hf}.attention.output.LayerNorm.weight"] = f"{pt}.attention_norm.weight"
        mapping[f"{hf}.attention.output.LayerNorm.bias"] = f"{pt}.attention_norm.bias"
        mapping[f"{hf}.intermediate.dense.weight"] = f"{pt}.intermediate.weight"
        mapping[f"{hf}.intermediate.dense.bias"] = f"{pt}.intermediate.bias"
        mapping[f"{hf}.output.dense.weight"] = f"{pt}.mlp_output.weight"
        mapping[f"{hf}.output.dense.bias"] = f"{pt}.mlp_output.bias"
        mapping[f"{hf}.output.LayerNorm.weight"] = f"{pt}.output_norm.weight"
        mapping[f"{hf}.output.LayerNorm.bias"] = f"{pt}.output_norm.bias"
    return mapping


def load_hf_weights(config: EncoderConfig, path: str) -> Optional[Dict[str, torch.Tensor]]:
    """Load a local HF safetensors checkpoint into a ``state_dict``; None if
    absent or incompatible. HF ``Linear`` weights are already [out, in]."""
    ckpt_dir = Path(path)
    files = sorted(ckpt_dir.glob("*.safetensors")) if ckpt_dir.exists() else []
    if not files:
        return None
    from safetensors.numpy import load_file

    tensors: Dict[str, np.ndarray] = {}
    for f in files:
        tensors.update(load_file(str(f)))
    prefixes = ("roberta.", "bert.", "model.", "")
    state: Dict[str, torch.Tensor] = {}
    for hf_key, key in _hf_key_map(config.num_layers).items():
        value = None
        for prefix in prefixes:
            value = tensors.get(prefix + hf_key)
            if value is not None:
                break
        if value is None:
            return None  # incompatible checkpoint
        state[key] = torch.from_numpy(np.asarray(value, np.float32))
    return state


def build_encoder(config: EncoderConfig, device, weights_path: str = "",
                  seed: int = 0):
    """→ (encoder on ``device``, pretrained flag): HF weights when the path
    holds a compatible checkpoint, else a seeded random init."""
    model = TransformerEncoder(config, device=device)
    state = load_hf_weights(config, weights_path) if weights_path else None
    if state is None:
        return model.init_random(seed), False
    model.load_state_dict(state)
    return model, True
