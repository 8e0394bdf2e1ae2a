"""Sparse (lexical) term-match scan: the K3/K3b CUDA kernel and its plain
version.

K3 (``csrc/sparse_scan.cu``) replaces the TPU kernels
``automative_rag_tpu/ops/sparse_scan.py:_scan_kernel`` and
``_scan_kernel_batch``; one kernel with a batch dimension serves the
single-query and the batched scan. Over a term-major slab it computes

    score[b, n] = Σ_t w[t, n] · Σ_q [ids[t, n] == q_ids[b, q]] · q_w[b, q]

``sparse_scores_tm_batch`` dispatches on the slab's device: CUDA launches
the kernel (or raises), CPU takes the plain version, a port of the
reference's ``fori`` formulation (``q_w[q] · Σ_t hit``, the other
summation order — scores agree to rounding).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..backend import check_launch, current_stream, host_to_device, kernel_lib


def sparse_scores_tm_plain(ids_t: torch.Tensor, w_t: torch.Tensor,
                           q_ids: torch.Tensor, q_w: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version: ids_t [T, cap] int, w_t [T, cap], q_ids/q_w [B, Q]
    → [B, cap] f32 (per-query-term accumulation, the ``fori`` form)."""
    w = w_t.float()
    q_w = q_w.float()
    out = torch.zeros((q_ids.shape[0], ids_t.shape[1]), dtype=torch.float32,
                      device=ids_t.device)
    for i in range(q_ids.shape[1]):
        hit = torch.where(ids_t[None, :, :] == q_ids[:, i][:, None, None],
                          w[None], 0.0).sum(dim=1)  # [B, cap]
        out += q_w[:, i][:, None] * hit
    return out


def _launch_fn():
    lib = kernel_lib("sparse_scan")
    fn = lib.sparse_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def sparse_scores_tm_cuda(ids_t: torch.Tensor, w_t: torch.Tensor,
                          q_ids: torch.Tensor, q_w: torch.Tensor
                          ) -> torch.Tensor:
    """K3/K3b on the card: ids_t [T, cap] int32, w_t [T, cap] bf16,
    q_ids [B, Q] int32, q_w [B, Q] f32 → [B, cap] f32."""
    dev = ids_t.device
    if dev.type != "cuda":
        raise ValueError("sparse_scores_tm_cuda needs CUDA tensors")
    for name, t in (("w_t", w_t), ("q_ids", q_ids), ("q_w", q_w)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the slab on {dev}")
    if ids_t.dtype != torch.int32 or w_t.dtype != torch.bfloat16:
        raise TypeError(f"K3 takes int32 ids and bf16 weights, got {ids_t.dtype}, {w_t.dtype}")
    if q_ids.dtype != torch.int32 or q_w.dtype != torch.float32:
        raise TypeError(f"K3 takes int32/f32 query terms, got {q_ids.dtype}, {q_w.dtype}")
    if ids_t.dim() != 2 or ids_t.shape != w_t.shape:
        raise ValueError(f"slab shapes {tuple(ids_t.shape)} / {tuple(w_t.shape)}")
    if q_ids.dim() != 2 or q_ids.shape != q_w.shape:
        raise ValueError(f"query shapes {tuple(q_ids.shape)} / {tuple(q_w.shape)}")
    for name, t in (("ids_t", ids_t), ("w_t", w_t), ("q_ids", q_ids), ("q_w", q_w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_terms, cap = ids_t.shape
    b, n_q = q_ids.shape
    if 8 * n_q * 8 > 40 * 1024:
        raise ValueError(f"K3 holds 8 x Q query terms in shared memory; Q={n_q} too wide")
    out = torch.empty((b, cap), dtype=torch.float32, device=dev)
    if b == 0 or cap == 0:
        return out
    lib, fn = _launch_fn()
    err = fn(ids_t.data_ptr(), w_t.data_ptr(), q_ids.data_ptr(), q_w.data_ptr(),
             out.data_ptr(), n_terms, cap, b, n_q, current_stream(dev))
    check_launch(lib, "sparse_scan", err)
    sparse_scores_tm_cuda.launches += 1
    return out


sparse_scores_tm_cuda.launches = 0


def sparse_scores_tm_batch(ids_t: torch.Tensor, w_t: torch.Tensor,
                           q_ids, q_w) -> torch.Tensor:
    """Batched scan over the term-major slab → [B, cap] f32; the kernel on
    the card, the plain version on the CPU."""
    dev = ids_t.device
    q_ids = host_to_device(np.asarray(q_ids, np.int32), dev)
    q_w = host_to_device(np.asarray(q_w, np.float32), dev)
    if q_ids.dim() == 1:
        q_ids, q_w = q_ids[None], q_w[None]
    if dev.type == "cuda":
        return sparse_scores_tm_cuda(ids_t, w_t, q_ids.contiguous(),
                                     q_w.contiguous())
    if dev.type == "cpu":
        return sparse_scores_tm_plain(ids_t, w_t, q_ids, q_w)
    raise ValueError(f"no sparse-scan path for device {dev}")
