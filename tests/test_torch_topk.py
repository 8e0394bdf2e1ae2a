"""Top-k selection of the PyTorch port against the JAX package.

Ties resolve to the lowest index in both (``lax.top_k``'s contract, a stable
sort in the port); masked slots are ``-inf`` with arbitrary rows, so only
finite entries are compared. Tolerance: exact (selection moves values, it
does not compute them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automative_rag_tpu.ops import topk as jtopk
from automative_rag_tpu_torch.ops import topk as ttopk


def _finite_equal(jv, ji, tv, ti):
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isfinite(jv), np.isfinite(tv))
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(jv[fin], tv[fin])
    np.testing.assert_array_equal(ji[fin], ti[fin])


@pytest.mark.parametrize("n,k,levels", [(300, 20, 5), (1000, 64, 3), (70000, 40, 50)])
def test_masked_top_k_matches_jax_with_ties(n, k, levels):
    rng = np.random.default_rng(n)
    # few distinct values → many ties; a quarter of the rows masked
    scores = rng.integers(0, levels, (3, n)).astype(np.float32) / levels
    mask = rng.random(n) > 0.25
    jv, ji = jtopk.masked_top_k(jnp.asarray(scores), jnp.asarray(mask), k)
    tv, ti = ttopk.masked_top_k(torch.from_numpy(scores), torch.from_numpy(mask), k)
    _finite_equal(jv, ji, tv, ti)


def test_masked_top_k_fewer_valid_than_k():
    rng = np.random.default_rng(1)
    scores = rng.random((2, 50)).astype(np.float32)
    mask = np.zeros(50, bool)
    mask[[3, 7, 11]] = True
    jv, ji = jtopk.masked_top_k(jnp.asarray(scores), jnp.asarray(mask), 8)
    tv, ti = ttopk.masked_top_k(torch.from_numpy(scores), torch.from_numpy(mask), 8)
    assert np.isinf(tv.numpy()[:, 3:]).all()
    _finite_equal(jv, ji, tv, ti)


@pytest.mark.parametrize("n,block", [(40000, 16384), (50001, 8192), (9000, 4096)])
def test_hierarchical_top_k_matches_jax(n, block):
    rng = np.random.default_rng(n)
    scores = rng.integers(0, 7, (2, n)).astype(np.float32)
    jv, ji = jtopk.hierarchical_top_k(jnp.asarray(scores), 25, block=block)
    tv, ti = ttopk.hierarchical_top_k(torch.from_numpy(scores), 25, block=block)
    _finite_equal(jv, ji, tv, ti)


def test_merge_top_k_matches_jax():
    rng = np.random.default_rng(2)
    values = np.sort(rng.integers(0, 5, (4, 3, 6)).astype(np.float32), axis=-1)[..., ::-1]
    indices = rng.integers(0, 1000, (4, 3, 6)).astype(np.int64)
    jv, ji = jtopk.merge_top_k(jnp.asarray(values.copy()), jnp.asarray(indices), 10)
    tv, ti = ttopk.merge_top_k(torch.from_numpy(values.copy()), torch.from_numpy(indices), 10)
    _finite_equal(jv, ji, tv, ti)
