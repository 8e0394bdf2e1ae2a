"""Flat index of the PyTorch port against the JAX package.

Both store bf16 vectors and score with f32 accumulation, so the same rows
come back in the same order; scores agree to 1e-5 (sums in another order).
Covers unfiltered and filtered search, the host-searched append tail,
upserts (which tombstone the old row), the host helpers the sparse arm
uses, and a checkpoint saved by either package loading in the other.
"""

import numpy as np
import pytest

from automative_rag_tpu.documents.schema import Document as JDocument
from automative_rag_tpu.index.flat import FlatIndex as JFlat
from automative_rag_tpu_torch.documents.schema import Document as TDocument
from automative_rag_tpu_torch.index.flat import FlatIndex as TFlat

DIM = 32
MANUS = ["宝马", "奔驰", "特斯拉", "丰田"]
FILTERS = [None, {"manufacturer": "宝马"}, {"manufacturer": ["特斯拉", "丰田"], "year": 2023},
           {"year": {"gte": 2021, "lte": 2022}}, {"manufacturer": "Porsche"},
           {"vin": "bad field"}]


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    metas = [{"id": f"d{seed}-{i}", "manufacturer": MANUS[i % 4],
              "year": 2020 + i % 4, "source_id": f"s{i}"} for i in range(n)]
    return vecs, metas


def _docs(cls, metas):
    return [cls(page_content=f"text {m['id']}", metadata=dict(m)) for m in metas]


def _pair(n=300, seed=0):
    vecs, metas = _corpus(seed, n)
    j, t = JFlat(dim=DIM), TFlat(dim=DIM, device="cpu")
    j.add(vecs, _docs(JDocument, metas))
    t.add(vecs, _docs(TDocument, metas))
    return j, t


def _same(got, want):
    assert [h.row for h in got] == [h.row for h in want]
    assert [h.document.id for h in got] == [h.document.id for h in want]
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want],
                               rtol=0, atol=1e-5)


def _queries(seed=7, b=4):
    return np.random.default_rng(seed).standard_normal((b, DIM)).astype(np.float32)


@pytest.mark.parametrize("flt", FILTERS, ids=[str(f) for f in FILTERS])
def test_search_matches_jax(flt):
    j, t = _pair()
    for got, want in zip(t.search(_queries(), 12, flt), j.search(_queries(), 12, flt)):
        _same(got, want)


def _upsert(index, cls, metas, seed):
    """Re-add documents under the ids in ``metas`` with new vectors."""
    vecs = np.random.default_rng(seed).standard_normal((len(metas), DIM)).astype(np.float32)
    index.add(vecs, _docs(cls, metas))


def test_host_tail_and_upsert_match_jax():
    j, t = _pair()
    q = _queries(8)
    for idx in (j, t):
        idx.search(q, 5)  # stage the slab
    vecs, metas = _corpus(1, 40)
    j.add(vecs, _docs(JDocument, metas))
    t.add(vecs, _docs(TDocument, metas))
    assert t._device is not None and t._device["staged_rows"] == 300
    for flt in FILTERS[:3]:
        for got, want in zip(t.search(q, 15, flt), j.search(q, 15, flt)):
            _same(got, want)
    upserted = [m for m in _corpus(0, 300)[1] if m["id"] in ("d0-3", "d0-10")]
    upserted += [m for m in metas if m["id"] == "d1-5"]
    _upsert(j, JDocument, upserted, 11)
    _upsert(t, TDocument, upserted, 11)
    assert t.count == j.count == 340 and t.total_rows == j.total_rows == 343
    for flt in FILTERS[:3]:
        for got, want in zip(t.search(q, 15, flt), j.search(q, 15, flt)):
            _same(got, want)


def test_host_helpers_match_jax():
    j, t = _pair(60)
    rows = [0, 5, 59, 60, 200, 17]
    for flt in (None, {"manufacturer": "宝马"}, {"vin": 1}):
        np.testing.assert_array_equal(t.rows_match(rows, flt), j.rows_match(rows, flt))
    qv = _queries(9, 1)[0]
    np.testing.assert_allclose(t.host_scores(rows, qv), j.host_scores(rows, qv), atol=1e-6)
    assert ([d and d.id for d in t.documents_at(rows)]
            == [d and d.id for d in j.documents_at(rows)])


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoints_cross_load(tmp_path, direction):
    j, t = _pair(120, seed=3)
    upserted = [m for m in _corpus(3, 120)[1] if m["id"] == "d3-7"]
    _upsert(j, JDocument, upserted, 12)
    _upsert(t, TDocument, upserted, 12)
    if direction == "jax_to_torch":
        j.save(str(tmp_path))
        loaded, ref = TFlat.load(str(tmp_path), device="cpu"), j
    else:
        t.save(str(tmp_path))
        loaded, ref = JFlat.load(str(tmp_path)), t
    q = _queries(4)
    for flt in (None, {"manufacturer": "奔驰"}):
        for got, want in zip(loaded.search(q, 9, flt), ref.search(q, 9, flt)):
            _same(got, want)
    assert loaded.count == ref.count == 120 and loaded.total_rows == ref.total_rows == 121
    assert loaded._row_of_id["d3-7"] == ref._row_of_id["d3-7"] == 120


def test_int8_slab_is_not_ported():
    with pytest.raises(NotImplementedError):
        TFlat(dim=DIM, device_dtype="int8", device="cpu")
