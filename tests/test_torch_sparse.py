"""Sparse scan and sparse index of the PyTorch port against the JAX package.

The port's plain scan (the ``fori`` form, ``q_w[q] · Σ_t hit``) is held
against the reference's Pallas kernels in interpret mode (the other
summation order) and its numpy oracle: rtol 1e-5 / atol 1e-5. The index
returns the same rows as the JAX index (its CPU ``fori`` variant) where
scores differ by more than that tolerance, scores within it, including
rows merged from the host tail. K3/K3b itself is held against the plain
version on the card in ``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automative_rag_tpu.index.sparse import SparseIndex as JSparseIndex
from automative_rag_tpu.models.bge_m3 import DenseEmbedder as JDense
from automative_rag_tpu.models.encoder import EncoderConfig as JConfig
from automative_rag_tpu.models.sparse import SparseEncoder as JSparseEncoder
from automative_rag_tpu.ops import sparse_scan as jss
from automative_rag_tpu_torch.index.sparse import SparseIndex as TSparseIndex
from automative_rag_tpu_torch.models.bge_m3 import DenseEmbedder as TDense
from automative_rag_tpu_torch.models.encoder import EncoderConfig as TConfig
from automative_rag_tpu_torch.models.sparse import SparseEncoder as TSparseEncoder
from automative_rag_tpu_torch.ops import sparse_scan as tss

RTOL, ATOL = 1e-5, 1e-5


def _slab(seed, t=16, cap=512, vocab=60):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (t, cap)).astype(np.int32)
    w = rng.random((t, cap)).astype(np.float32)
    pad = rng.random((t, cap)) < 0.2
    ids[pad] = -1
    w[pad] = 0.0
    w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))  # bf16 values
    return ids, w


def _queries(seed, b, q, vocab=60):
    rng = np.random.default_rng(seed + 100)
    ids = np.stack([rng.choice(vocab, q, replace=False) for _ in range(b)]).astype(np.int32)
    w = rng.random((b, q)).astype(np.float32)
    ids[:, -2:] = -1  # pad terms
    w[:, -2:] = 0.0
    return ids, w


@pytest.mark.parametrize("seed,q", [(0, 8), (1, 16), (2, 24)])
def test_plain_scan_matches_pallas_interpret_and_oracle(seed, q):
    ids, w = _slab(seed)
    q_ids, q_w = _queries(seed, 1, q)
    got = tss.sparse_scores_tm_plain(torch.from_numpy(ids), torch.from_numpy(w).bfloat16(),
                                     torch.from_numpy(q_ids), torch.from_numpy(q_w))[0].numpy()
    pallas = np.asarray(jss.sparse_scores_tm(
        jnp.asarray(ids), jnp.asarray(w, jnp.bfloat16), jnp.asarray(q_ids[0]),
        jnp.asarray(q_w[0]), block_n=256, interpret=True))
    oracle = jss.np_scores_tm(ids, w, q_ids[0], q_w[0])
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b", [1, 3])
def test_plain_batch_scan_matches_pallas_batch(b):
    ids, w = _slab(3)
    q_ids, q_w = _queries(3, b, 8)
    got = tss.sparse_scores_tm_batch(torch.from_numpy(ids), torch.from_numpy(w).bfloat16(),
                                     q_ids, q_w).numpy()
    pallas = np.asarray(jss.sparse_scores_tm_batch(
        jnp.asarray(ids), jnp.asarray(w, jnp.bfloat16), jnp.asarray(q_ids),
        jnp.asarray(q_w), block_n=256, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    before = tss.sparse_scores_tm_cuda.launches
    single = tss.sparse_scores_tm_batch(torch.from_numpy(ids), torch.from_numpy(w).bfloat16(),
                                        q_ids[0], q_w[0]).numpy()
    np.testing.assert_allclose(single[0], got[0], rtol=0, atol=0)
    assert tss.sparse_scores_tm_cuda.launches == before  # CPU: plain only


def _encoders():
    jd = JDense(config=JConfig.tiny(hidden_size=32))
    td = TDense(config=TConfig.tiny(hidden_size=32), device="cpu")
    return (JSparseEncoder(jd, top_terms=12, query_terms=16),
            TSparseEncoder(td, top_terms=12, query_terms=16))


CORPUS = [
    "宝马5系 2023款 加速时间 6.9秒 xDrive40i",
    "宝马X5 2022款 SUV 动力强劲 xDrive30d",
    "奔驰E级 2023款 舒适豪华 E300L",
    "特斯拉Model 3 2023款 纯电动 续航 606 公里",
    "丰田凯美瑞 2021款 混合动力 油耗 4.1",
    "Tesla Model Y 2022 electric SUV range 545km",
    "比亚迪汉EV 续航 715 公里 刀片电池",
    "蔚来ES6 换电 续航 610 公里",
] * 3

QUERIES = ["xDrive40i 加速", "续航 公里", "Model 3 纯电动", "油耗 混合动力", "刀片电池 汉EV"]


def test_sparse_encoders_match():
    je, te = _encoders()
    ji, jw = je.encode_documents(CORPUS)
    ti, tw = te.encode_documents(CORPUS)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    for q in QUERIES:
        for a, b in zip(te.encode_query(q), je.encode_query(q)):
            np.testing.assert_array_equal(a, b)


def _assert_same_hits(got, want):
    assert len(got) == len(want)
    g_rows, g_scores = np.array([r for r, _ in got]), np.array([s for _, s in got])
    w_rows, w_scores = np.array([r for r, _ in want]), np.array([s for _, s in want])
    np.testing.assert_allclose(g_scores, w_scores, rtol=RTOL, atol=ATOL)
    # rows must agree wherever the score order is not a near-tie
    distinct = np.abs(np.diff(w_scores, prepend=np.inf, append=-np.inf))
    clear = (distinct[:-1] > ATOL) & (distinct[1:] > ATOL)
    np.testing.assert_array_equal(g_rows[clear], w_rows[clear])


def _indexes():
    je, te = _encoders()
    ids, w = je.encode_documents(CORPUS)
    jidx, tidx = JSparseIndex(top_terms=12), TSparseIndex(top_terms=12, device="cpu")
    jidx.scan_variant = "fori"
    for idx in (jidx, tidx):
        idx.append(ids[:16], w[:16])
    return je, te, jidx, tidx, ids, w


def test_search_and_search_batch_match_jax_with_host_tail():
    je, te, jidx, tidx, ids, w = _indexes()
    terms = [te.encode_query(q) for q in QUERIES]
    terms = [(i, w_ * tidx.idf(i)) for i, w_ in terms]
    for q_ids, q_w in terms[:2]:
        _assert_same_hits(tidx.search(q_ids, q_w, 6), jidx.search(q_ids, q_w, 6))
    # stage the slab, then append: the new rows score on the host and merge
    for idx in (jidx, tidx):
        idx.append(ids[16:], w[16:])
    assert tidx._device[2] == 16 and tidx.rows == 24
    for q_ids, q_w in terms:
        _assert_same_hits(tidx.search(q_ids, q_w, 10), jidx.search(q_ids, q_w, 10))
    q_ids = np.stack([t[0] for t in terms])
    q_w = np.stack([t[1] for t in terms])
    for got, want in zip(tidx.search_batch(q_ids, q_w, 7), jidx.search_batch(q_ids, q_w, 7)):
        _assert_same_hits(got, want)


def test_idf_score_rows_and_trim_match():
    je, te, jidx, tidx, ids, w = _indexes()
    q_ids, q_w = te.encode_query("续航 公里 纯电动")
    np.testing.assert_array_equal(tidx.idf(q_ids), jidx.idf(q_ids))
    rows = [0, 5, 15, 99, -1]
    np.testing.assert_array_equal(tidx.score_rows(rows, q_ids, q_w),
                                  jidx.score_rows(rows, q_ids, q_w))
    for a, b in zip(TSparseIndex._trim_query_width(q_ids, q_w),
                    JSparseIndex._trim_query_width(q_ids, q_w)):
        np.testing.assert_array_equal(a, b)


def test_save_load_cross_package(tmp_path):
    je, te, jidx, tidx, ids, w = _indexes()
    tidx.select_rows([3, 1, 0, 7])
    tidx.save(str(tmp_path))
    loaded = JSparseIndex.load(str(tmp_path))
    np.testing.assert_array_equal(loaded._ids, ids[[3, 1, 0, 7]])
    back = TSparseIndex.load(str(tmp_path), device="cpu")
    assert back.rows == 4 and back._df == loaded._df
