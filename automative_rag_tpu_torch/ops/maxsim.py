"""Late-interaction MaxSim: the K1 CUDA kernel and its plain version.

K1 (``csrc/maxsim.cu``) replaces the TPU kernel
``automative_rag_tpu/ops/maxsim.py:_maxsim_kernel`` together with the
candidate gather in front of it: it reads each candidate's token slab
straight out of the store by row id. It is bound by the bytes of the
candidate slabs (see the note at the top of the source).

``maxsim_gather`` dispatches on the device of the store's tokens: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain
version. Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ..backend import check_launch, current_stream, host_to_device, kernel_lib

NEG_BIAS = -1e30
_Q_TILE = 32  # query tokens per kernel tile (the kernel's lane count)


def maxsim_scores_ref(q: torch.Tensor, q_mask: torch.Tensor,
                      docs: torch.Tensor, d_mask: torch.Tensor) -> torch.Tensor:
    """Plain version (port of ``maxsim_scores_ref``): q [B, Lq, D], q_mask
    [B, Lq] bool, docs [N, Ld, D], d_mask [N, Ld] bool → [B, N] f32."""
    qw = q_mask.float()
    d_bias = torch.where(d_mask, 0.0, NEG_BIAS).float()
    sim = torch.einsum("bqd,ntd->bqnt", q.float(), docs.float())
    sim = sim + d_bias[None, None, :, :]
    per_qtok = sim.amax(dim=-1)  # [B, Lq, N]
    return (per_qtok * qw[:, :, None]).sum(dim=1)


def _rows_tensor(rows, device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=torch.int64).reshape(-1)
    return host_to_device(np.asarray(rows, np.int64).reshape(-1), device)


def maxsim_gather_plain(q: torch.Tensor, q_mask: torch.Tensor,
                        tokens: torch.Tensor, masks: torch.Tensor,
                        rows: Sequence[int]) -> torch.Tensor:
    """Plain version of the fused gather + MaxSim: tokens [cap, Ld, D],
    masks [cap, Ld], rows in [-1, cap) (row -1 is all padding)."""
    r = _rows_tensor(rows, tokens.device)
    valid = r >= 0
    safe = torch.where(valid, r, torch.zeros_like(r))
    d_mask = masks[safe].bool() & valid[:, None]
    return maxsim_scores_ref(q, q_mask, tokens[safe], d_mask)


def _launch_fn():
    lib = kernel_lib("maxsim")
    fn = lib.maxsim_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.maxsim_num_splits.argtypes = [ctypes.c_int]
        lib.maxsim_num_splits.restype = ctypes.c_int
        lib.maxsim_smem_bytes.argtypes = [ctypes.c_int]
        lib.maxsim_smem_bytes.restype = ctypes.c_int
    return lib, fn


def maxsim_gather_cuda(q: torch.Tensor, q_mask: torch.Tensor,
                       tokens: torch.Tensor, masks: torch.Tensor,
                       rows: Sequence[int]) -> torch.Tensor:
    """K1 on the card: q [B, Lq, D] bf16, q_mask [B, Lq], tokens
    [cap, Ld, D] bf16, masks [cap, Ld] bool, rows in [-1, cap) → [B, N]
    f32. Host rows outside [-1, cap) raise here; rows already on the card
    are not read back, and the kernel scores any of them outside [0, cap)
    as all padding instead of reading past the slab."""
    dev = tokens.device
    if dev.type != "cuda":
        raise ValueError("maxsim_gather_cuda needs CUDA tensors")
    if q.device != dev or masks.device != dev:
        raise ValueError("q, tokens and masks must be on one device")
    if q.dtype != torch.bfloat16 or tokens.dtype != torch.bfloat16:
        raise TypeError(f"K1 takes bf16 q and tokens, got {q.dtype}, {tokens.dtype}")
    if masks.dtype != torch.bool:
        raise TypeError(f"K1 takes bool masks, got {masks.dtype}")
    if q.dim() != 3 or tokens.dim() != 3 or masks.dim() != 2:
        raise ValueError("expected q [B, Lq, D], tokens [cap, Ld, D], masks [cap, Ld]")
    b, lq, dim = q.shape
    cap, ld, dim_t = tokens.shape
    if dim_t != dim or tuple(masks.shape) != (cap, ld) or tuple(q_mask.shape) != (b, lq):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, q_mask {tuple(q_mask.shape)}, "
            f"tokens {tuple(tokens.shape)}, masks {tuple(masks.shape)}")
    if dim % 32:
        raise ValueError(f"K1 needs D % 32 == 0, got {dim}")
    if not (tokens.is_contiguous() and masks.is_contiguous()):
        raise ValueError("tokens and masks must be contiguous")
    if not isinstance(rows, torch.Tensor):
        rows_np = np.asarray(rows, np.int64).reshape(-1)
        if rows_np.size and (rows_np.min() < -1 or rows_np.max() >= cap):
            raise IndexError(f"rows must lie in [-1, {cap})")
        rows = rows_np
    elif rows.device != dev or rows.dtype != torch.int64:
        raise TypeError("device rows must be int64 on the tokens' device")
    rows_d = _rows_tensor(rows, dev)
    n = rows_d.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if n == 0 or b == 0:
        return out
    lib, fn = _launch_fn()
    if lib.maxsim_smem_bytes(dim) > 227 * 1024:
        raise ValueError(f"K1 stages 32 x {dim} bf16 query tokens; too wide")
    q_mask = q_mask.to(device=dev, dtype=torch.bool)
    lq_pad = -(-lq // _Q_TILE) * _Q_TILE
    if lq_pad == lq:
        q_pad, qm = q.contiguous(), q_mask.contiguous()
    else:  # masked zero tokens up to the kernel's tile of 32
        q_pad = torch.zeros((b, lq_pad, dim), dtype=torch.bfloat16, device=dev)
        q_pad[:, :lq] = q
        qm = torch.zeros((b, lq_pad), dtype=torch.bool, device=dev)
        qm[:, :lq] = q_mask
    splits = lib.maxsim_num_splits(ld)
    partial = torch.empty((b, n, splits, lq_pad), dtype=torch.float32, device=dev)
    err = fn(q_pad.data_ptr(), qm.data_ptr(), tokens.data_ptr(),
             masks.data_ptr(), rows_d.data_ptr(), partial.data_ptr(),
             out.data_ptr(), b, lq_pad, dim, ld, n, cap, current_stream(dev))
    check_launch(lib, "maxsim", err)
    maxsim_gather_cuda.launches += 1
    return out


maxsim_gather_cuda.launches = 0


def maxsim_gather(q: torch.Tensor, q_mask, tokens: torch.Tensor,
                  masks: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """Fused candidate gather + MaxSim → [B, N] f32. On the card the query
    goes to bf16, the kernel's operand type (as the TPU path normalizes
    fp16 to bf16), and the store's tokens must already be bf16; on the CPU
    the plain version computes in f32 from whatever precision it is given."""
    q_mask = (q_mask if isinstance(q_mask, torch.Tensor)
              else host_to_device(np.asarray(q_mask, bool), tokens.device))
    q_mask = q_mask.to(tokens.device).bool()
    if tokens.device.type == "cuda":
        return maxsim_gather_cuda(
            q.to(device=tokens.device, dtype=torch.bfloat16), q_mask,
            tokens, masks.bool().contiguous(), rows)
    if tokens.device.type == "cpu":
        return maxsim_gather_plain(q.to(tokens.device), q_mask, tokens,
                                   masks, rows)
    raise ValueError(f"no MaxSim path for device {tokens.device}")


def maxsim_argmax_ref(q: torch.Tensor, q_mask: torch.Tensor,
                      doc: torch.Tensor, d_mask: torch.Tensor):
    """Per-query-token best doc token and similarity ([Lq, D] query, [Ld, D]
    doc) — powers token-level match explanations."""
    sim = q.float() @ doc.float().T
    sim = sim + torch.where(d_mask.bool(), 0.0, NEG_BIAS)[None, :]
    best = sim.argmax(dim=1)
    best_sim = sim.amax(dim=1)
    return best, torch.where(q_mask.bool(), best_sim, 0.0)


def min_max_normalize(scores: np.ndarray) -> np.ndarray:
    """Per-candidate-set min-max normalization (constant lists → all ones)."""
    scores = np.asarray(scores, np.float64)
    if scores.size == 0:
        return scores
    lo, hi = scores.min(), scores.max()
    if hi - lo > 0:
        return (scores - lo) / (hi - lo)
    return np.ones_like(scores)
