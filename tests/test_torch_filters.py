"""Metadata filter masks of the PyTorch port against the JAX package.

The DSL cases are those of ``tests/test_filters.py``; the port's tensor
mask and its numpy mirror must be bit-identical to the reference's
``eval_filter_mask_np`` (tolerance: exact).
"""

import numpy as np
import pytest
import torch

from automative_rag_tpu.index import filters as jf
from automative_rag_tpu_torch.index import filters as tf

METADATAS = [
    {"manufacturer": "BMW", "model": "X5", "year": 2022, "category": "suv"},
    {"manufacturer": "BMW", "model": "5 Series", "year": 2023, "category": "sedan"},
    {"manufacturer": "Tesla", "model": "Model 3", "year": 2023, "category": "sedan"},
    {"manufacturer": "Toyota", "model": "Camry", "year": 2021},
    {"model": "Unknown"},  # missing manufacturer/year
]

CASES = [
    None,
    {},
    {"manufacturer": "BMW"},
    {"manufacturer": ["BMW", "Tesla"]},
    {"year": 2023},
    {"year": 2023.0},
    {"year": [2021, 2022]},
    {"manufacturer": "BMW", "year": 2023},
    {"manufacturer": "Porsche"},
    {"manufacturer": ["BMW", "Tesla", "Toyota"]},
    {"manufacturer": None, "model": [], "year": 2023},
    {"year": {"gte": 2022}},
    {"year": {"gte": 2021, "lte": 2022}, "category": "suv"},
    {"year": {"lte": None}},
]


def _columns(module, metadatas, capacity=128):
    cols = module.MetadataColumns()
    cols.append_rows(metadatas, capacity=capacity)
    return cols


@pytest.mark.parametrize("flt", CASES, ids=[str(c) for c in CASES])
def test_masks_bit_identical_to_reference(flt):
    jcols, tcols = _columns(jf, METADATAS), _columns(tf, METADATAS)
    want = jf.eval_filter_mask_np(jcols.codes, jcols.numerics,
                                  jf.compile_filter(flt, jcols))
    spec = tf.compile_filter(flt, tcols, "cpu")
    got = tf.eval_filter_mask(torch.from_numpy(tcols.codes),
                              torch.from_numpy(tcols.numerics), spec).numpy()
    got_np = tf.eval_filter_mask_np(tcols.codes, tcols.numerics, spec)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_np, want)


@pytest.mark.parametrize("flt", [{"vin_number": "abc"},
                                 {"year": list(range(2000, 2020))},
                                 {"model": {"gte": 1}}])
def test_compile_errors_match_reference(flt):
    with pytest.raises(jf.FilterError):
        jf.compile_filter(flt, _columns(jf, METADATAS))
    with pytest.raises(tf.FilterError):
        tf.compile_filter(flt, _columns(tf, METADATAS), "cpu")


def test_spec_is_fixed_shape():
    cols = _columns(tf, METADATAS)
    spec = tf.compile_filter({"manufacturer": "BMW"}, cols, "cpu")
    blank = tf.FilterSpec.match_all("cpu")
    for a, b in zip(spec, blank):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert spec.terms.shape == (tf.MAX_CONDITIONS, tf.MAX_TERMS)


def test_randomized_filters_bit_identical(rng):
    manus = ["宝马", "奔驰", "特斯拉", "丰田", None]
    models = ["X5", "5系", "Model 3", None]
    metadatas = []
    for _ in range(300):
        md = {}
        if (m := manus[rng.integers(len(manus))]):
            md["manufacturer"] = m
        if (m := models[rng.integers(len(models))]):
            md["model"] = m
        if rng.random() < 0.8:
            md["year"] = int(2015 + rng.integers(10))
        metadatas.append(md)
    jcols, tcols = _columns(jf, metadatas, 512), _columns(tf, metadatas, 512)
    for _ in range(30):
        flt = {}
        if rng.random() < 0.7:
            flt["manufacturer"] = list(rng.choice(["宝马", "奔驰", "特斯拉", "本田"],
                                                  rng.integers(1, 3), replace=False))
        if rng.random() < 0.5:
            flt["year"] = int(2015 + rng.integers(10))
        if rng.random() < 0.3:
            flt["model"] = "X5"
        want = jf.eval_filter_mask_np(jcols.codes, jcols.numerics,
                                      jf.compile_filter(flt, jcols))
        got = tf.eval_filter_mask(torch.from_numpy(tcols.codes),
                                  torch.from_numpy(tcols.numerics),
                                  tf.compile_filter(flt, tcols, "cpu")).numpy()
        np.testing.assert_array_equal(got, want)
