"""MaxSim of the PyTorch port against the JAX package.

On the CPU the port's plain version (a port of ``maxsim_scores_ref``) is
held against the reference's ``maxsim_scores_ref`` and its Pallas kernel in
interpret mode, with padded docs, masked query tokens and N not a multiple
of the kernel's block: f32 on both sides, rtol 1e-5 / atol 1e-4 (sums in
another order). The token stores of both packages round tokens the same
way (f32 → fp16 → bf16), so scores from the stores agree to the same
tolerance. K1 itself is held against this plain version on the card in
``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from automative_rag_tpu.ops import maxsim as jms
from automative_rag_tpu.rerank.token_store import TokenStore as JTokenStore
from automative_rag_tpu_torch.ops import maxsim as tms
from automative_rag_tpu_torch.rerank.token_store import TokenStore as TTokenStore

RTOL, ATOL = 1e-5, 1e-4


def _case(seed, b=2, lq=8, n=13, ld=16, dim=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, dim)).astype(np.float32)
    q_mask = rng.random((b, lq)) > 0.3
    q_mask[:, 0] = False
    docs = rng.standard_normal((n, ld, dim)).astype(np.float32)
    lengths = rng.integers(1, ld + 1, n)
    d_mask = np.arange(ld)[None, :] < lengths[:, None]
    return q, q_mask, docs, d_mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,n", [(0, 13), (1, 5), (2, 130)])
def test_plain_matches_reference_and_pallas_interpret(seed, n):
    q, q_mask, docs, d_mask = _case(seed, n=n)
    got = tms.maxsim_scores_ref(*_t(q, q_mask, docs, d_mask)).numpy()
    ref = np.asarray(jms.maxsim_scores_ref(*map(jnp.asarray, (q, q_mask, docs, d_mask))))
    pallas = np.asarray(jms.maxsim_scores_pallas(
        *map(jnp.asarray, (q, q_mask, docs, d_mask)), block_docs=8, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


def test_gather_plain_with_padding_rows():
    q, q_mask, docs, d_mask = _case(3, n=20)
    rows = np.array([7, 0, 19, -1, 7, 3])
    got = tms.maxsim_gather_plain(*_t(q, q_mask, docs, d_mask), rows).numpy()
    safe = np.maximum(rows, 0)
    sel_mask = d_mask[safe] & (rows >= 0)[:, None]
    ref = np.asarray(jms.maxsim_scores_ref(
        jnp.asarray(q), jnp.asarray(q_mask), jnp.asarray(docs[safe]), jnp.asarray(sel_mask)))
    real = rows >= 0
    np.testing.assert_allclose(got[:, real], ref[:, real], rtol=RTOL, atol=ATOL)
    assert (got[:, ~real] < -1e29).all()  # the padding row sinks


def test_dispatch_on_cpu_takes_the_plain_version():
    q, q_mask, docs, d_mask = _case(4)
    before = tms.maxsim_gather_cuda.launches
    got = tms.maxsim_gather(torch.from_numpy(q), q_mask, *_t(docs, d_mask), np.arange(13))
    want = tms.maxsim_scores_ref(*_t(q, q_mask, docs, d_mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=0)
    assert tms.maxsim_gather_cuda.launches == before


def test_token_stores_score_alike():
    """Same fp32 tokens into both stores, same fp16 query → same scores."""
    rng = np.random.default_rng(5)
    n, ld, dim = 24, 16, 32
    tokens = rng.standard_normal((n, ld, dim)).astype(np.float32)
    masks = np.arange(ld)[None, :] < rng.integers(1, ld + 1, n)[:, None]
    q = rng.standard_normal((1, 8, dim)).astype(np.float16)
    q_mask = np.ones((1, 8), bool)
    q_mask[0, 0] = False
    rows = [3, 17, 0, 9, 23, 9]
    jstore = JTokenStore(dim=dim, max_doc_length=ld)
    jstore.append(tokens[:10], masks[:10])
    jstore.append(tokens[10:], masks[10:])
    want = np.asarray(jstore.maxsim_fused(q, q_mask, rows))
    tstore = TTokenStore(dim=dim, max_doc_length=ld, device="cpu")
    tstore.append(tokens[:10], masks[:10])
    tstore.append(torch.from_numpy(tokens[10:]), masks[10:])
    assert tstore.rows == n
    got = tstore.maxsim_fused(torch.from_numpy(q), q_mask, rows).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_token_store_save_load_gather(tmp_path):
    rng = np.random.default_rng(6)
    tokens = rng.standard_normal((12, 8, 16)).astype(np.float32)
    masks = np.arange(8)[None, :] < rng.integers(1, 9, 12)[:, None]
    store = TTokenStore(dim=16, max_doc_length=8, device="cpu")
    store.append(tokens, masks)
    store.save(str(tmp_path))
    # the JAX package reads the port's checkpoint and vice versa
    jstore = JTokenStore.load(str(tmp_path), dim=16, max_doc_length=8)
    assert jstore.rows == 12
    q = rng.standard_normal((1, 4, 16)).astype(np.float16)
    q_mask = np.ones((1, 4), bool)
    loaded = TTokenStore.load(str(tmp_path), dim=16, max_doc_length=8, device="cpu")
    np.testing.assert_allclose(
        loaded.maxsim_fused(torch.from_numpy(q), q_mask, range(12)).numpy(),
        np.asarray(jstore.maxsim_fused(q, q_mask, list(range(12)))), rtol=RTOL, atol=ATOL)
    # rows past the store's end gather as all-padding
    docs, m = loaded.gather([5, 2, 12])
    np.testing.assert_array_equal(m.numpy(), np.stack([masks[5], masks[2], np.zeros(8, bool)]))
    np.testing.assert_array_equal(
        docs[:2].float().numpy(), tokens[[5, 2]].astype(np.float16).astype(np.float32)
        .astype(ml_dtypes.bfloat16).astype(np.float32))


def test_argmax_and_min_max_normalize_match():
    q, q_mask, docs, d_mask = _case(7)
    jb, js = jms.maxsim_argmax_ref(*map(jnp.asarray, (q[0], q_mask[0], docs[0], d_mask[0])))
    tb, ts = tms.maxsim_argmax_ref(*_t(q[0], q_mask[0], docs[0], d_mask[0]))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    for scores in ([3.0, 1.0, 2.0], [1.0, 1.0], []):
        np.testing.assert_array_equal(tms.min_max_normalize(scores),
                                      jms.min_max_normalize(scores))
