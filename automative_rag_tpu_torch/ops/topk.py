"""Masked top-k selection and shard-wise top-k merging.

Port of ``automative_rag_tpu/ops/topk.py``. ``jax.lax.top_k`` returns the
lowest index first among equal values; ``torch.topk`` promises no order on
ties, and sparse scores tie often. Selection here is a STABLE descending
sort, so ties resolve to the lowest index exactly as the reference does.
Masked-out slots come back as ``-inf`` (their rows are meaningless).
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")

#: last-axis length above which top-k runs hierarchically (per-block
#: selection + a merge over the block winners)
_TWO_STAGE_MIN = 32768
_TWO_STAGE_BLOCK = 16384


def top_k(scores: torch.Tensor, k: int):
    """Exact top-k over the last axis; equal values resolve to the lowest
    index (the ``lax.top_k`` contract). Returns (values, int64 indices)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def hierarchical_top_k(scores: torch.Tensor, k: int,
                       block: int = _TWO_STAGE_BLOCK):
    """Exact top-k via per-block top-k + candidate merge; handles a ragged
    remainder. Ties resolve to the lowest index, as the flat selection."""
    *lead, n = scores.shape
    if n <= max(block, k):
        return top_k(scores, k)
    n_blocks = n // block
    main = n_blocks * block
    k_local = min(k, block)
    blocked = scores[..., :main].reshape(*lead, n_blocks, block)
    vals, idx = top_k(blocked, k_local)  # [..., nb, kl]
    offsets = torch.arange(n_blocks, device=scores.device) * block
    gidx = idx + offsets[:, None]
    cand_v = vals.reshape(*lead, n_blocks * k_local)
    cand_i = gidx.reshape(*lead, n_blocks * k_local)
    if main < n:
        k_rem = min(k, n - main)
        rvals, ridx = top_k(scores[..., main:], k_rem)
        cand_v = torch.cat([cand_v, rvals], dim=-1)
        cand_i = torch.cat([cand_i, ridx + main], dim=-1)
    # candidates are ordered by block, then by in-block rank, so a stable
    # sort keeps the lowest global index first among equal values
    top_v, pos = top_k(cand_v, k)
    return top_v, torch.gather(cand_i, -1, pos)


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k over the last axis with a boolean validity mask ([N] or
    [..., N]); masked selections carry ``-inf``."""
    masked = torch.where(mask, scores.float(),
                         torch.full((), NEG_INF, device=scores.device))
    if masked.shape[-1] >= _TWO_STAGE_MIN:
        return hierarchical_top_k(masked, k)
    return top_k(masked, k)


def merge_top_k(values: torch.Tensor, indices: torch.Tensor, k: int):
    """Merge per-shard top-k lists ([n_shards, ..., k], global row ids)
    into a global top-k."""
    n_shards = values.shape[0]
    flat_vals = torch.movedim(values, 0, -2).reshape(
        *values.shape[1:-1], n_shards * values.shape[-1])
    flat_idx = torch.movedim(indices, 0, -2).reshape(
        *indices.shape[1:-1], n_shards * indices.shape[-1])
    top_vals, pos = top_k(flat_vals, k)
    return top_vals, torch.gather(flat_idx, -1, pos)
