"""Encoders of the PyTorch port against the JAX package (tiny configs).

- the XLM-R encoder's hidden states after ``load_flax_params``, both sides
  in f32 (JAX under ``default_matmul_precision("highest")``): atol 1e-4;
- the same after loading one HF safetensors checkpoint in both packages;
- lexical-mode dense vectors (uint32 hashing emulated in int64): 1e-6;
- transformer-mode ``DenseEmbedder`` vectors: 1e-4;
- ColBERT query/document embeddings (fp16 in both, the same rounding
  point): atol 2e-3, one fp16 step at these magnitudes; masks exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automative_rag_tpu.models import bge_m3 as jbge
from automative_rag_tpu.models import colbert as jcol
from automative_rag_tpu.models import encoder as jenc
from automative_rag_tpu_torch.models import bge_m3 as tbge
from automative_rag_tpu_torch.models import colbert as tcol
from automative_rag_tpu_torch.models import encoder as tenc

TEXTS = [
    "宝马5系 2023款 加速时间 6.9秒",
    "Tesla Model Y 2022 electric SUV range 500km, 续航 545 公里",
    "比亚迪汉EV 的 CLTC 续航里程为 715 公里。",
    "",
    "丰田凯美瑞 混合动力 油耗 4.1L/100km " * 6,
]


@pytest.fixture(scope="module")
def f32_configs():
    jcfg = dataclasses.replace(jenc.EncoderConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tenc.EncoderConfig.tiny(), dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def flax_params(f32_configs):
    return jax.device_get(jenc.init_encoder_params(f32_configs[0], seed=3))


def _inputs(seed, batch=3, length=24, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.int32)
    mask[1, 15:] = 0
    mask[2, 5:] = 0
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(value, "items"):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _jax_hidden(jcfg, params, ids, mask):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jenc.TransformerEncoder(jcfg).apply(
            {"params": params}, jnp.asarray(ids), jnp.asarray(mask)))


@pytest.mark.parametrize("seed", [0, 1])
def test_hidden_states_match_flax_f32(f32_configs, flax_params, seed):
    jcfg, tcfg = f32_configs
    ids, mask = _inputs(seed)
    model = tenc.TransformerEncoder(tcfg, device="cpu")
    model.load_state_dict(tenc.load_flax_params(tcfg, flax_params))
    got = model(ids, mask).numpy()
    np.testing.assert_allclose(got, _jax_hidden(jcfg, flax_params, ids, mask),
                               atol=1e-4, rtol=0)


def test_hf_checkpoint_loads_alike(tmp_path, f32_configs, flax_params):
    from safetensors.numpy import save_file

    jcfg, tcfg = f32_configs
    tensors = {}
    flat = _flatten(flax_params)
    for hf_key, flax_path in jenc._hf_key_map(jcfg.num_layers).items():
        value = flat[flax_path]
        tensors["roberta." + hf_key] = np.ascontiguousarray(
            value.T if flax_path.endswith("kernel") else value)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    jparams = jenc.load_hf_weights(jcfg, str(tmp_path))
    model, pretrained = tenc.build_encoder(tcfg, "cpu", str(tmp_path))
    assert pretrained
    ids, mask = _inputs(5)
    np.testing.assert_allclose(model(ids, mask).numpy(),
                               _jax_hidden(jcfg, jparams, ids, mask),
                               atol=1e-4, rtol=0)


def test_bf16_encoder_tracks_flax(flax_params):
    """bf16 compute on both sides rounds at the same points but sums in
    another order: mean abs error below 0.02, max below 0.25 on hidden
    states of unit scale."""
    jcfg = jenc.EncoderConfig.tiny()
    tcfg = tenc.EncoderConfig.tiny()
    ids, mask = _inputs(7)
    model = tenc.TransformerEncoder(tcfg, device="cpu")
    model.load_state_dict(tenc.load_flax_params(tcfg, flax_params))
    got = model(ids, mask).numpy()
    want = np.asarray(jenc.TransformerEncoder(jcfg).apply(
        {"params": flax_params}, jnp.asarray(ids), jnp.asarray(mask)))
    real = mask.astype(bool)
    err = np.abs(got - want)[real]
    assert err.mean() < 0.02 and err.max() < 0.25, (err.mean(), err.max())


def test_lexical_vectors_match():
    cfg_j = jenc.EncoderConfig.tiny(hidden_size=64)
    cfg_t = tenc.EncoderConfig.tiny(hidden_size=64)
    texts = TEXTS * 3  # > one batch of 8 → ragged-tail padding too
    want = jbge.DenseEmbedder(config=cfg_j, batch_size=8).embed_texts(texts)
    emb = tbge.DenseEmbedder(config=cfg_t, batch_size=8, device="cpu")
    assert emb.mode == "lexical" and emb.model is None
    got = emb.embed_texts(texts)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_lexical_hash_wraps_like_uint32():
    """Bigram hashes of large ids overflow 32 bits: the int64 emulation
    must wrap exactly like the reference's uint32 arithmetic."""
    cfg_j = jenc.EncoderConfig(vocab_size=250002, hidden_size=96, num_layers=1,
                               num_heads=2, intermediate_size=8, max_position=64)
    cfg_t = tenc.EncoderConfig(vocab_size=250002, hidden_size=96, num_layers=1,
                               num_heads=2, intermediate_size=8, max_position=64)
    rng = np.random.default_rng(0)
    ids = rng.integers(200000, 250002, (4, 32)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[3, 20:] = 0
    je = jbge.DenseEmbedder(config=cfg_j)
    want = np.asarray(je._lexical(jnp.asarray(ids), jnp.asarray(mask)))
    got = tbge.lexical_embed(torch.from_numpy(ids), torch.from_numpy(mask), 96).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_transformer_dense_embedder_matches(f32_configs, flax_params):
    jcfg, tcfg = f32_configs
    with jax.default_matmul_precision("highest"):
        want = jbge.DenseEmbedder.from_params(jcfg, flax_params, max_length=64).embed_texts(TEXTS)
    emb = tbge.DenseEmbedder.from_flax_params(tcfg, flax_params, max_length=64, device="cpu")
    got = emb.embed_texts(TEXTS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_colbert_embeddings_and_masks_match(f32_configs):
    jcfg, tcfg = f32_configs
    with jax.default_matmul_precision("highest"):
        jc = jcol.ColBERTEncoder(config=jcfg, max_query_length=32, max_doc_length=64)
        jq, jqm = jc.encode_queries(TEXTS)
        jd, jdm = jc.encode_documents(TEXTS)
    tc = tcol.ColBERTEncoder(config=tcfg, max_query_length=32, max_doc_length=64,
                             device="cpu").load_flax_params(jax.device_get(jc.params))
    tq, tqm = tc.encode_queries(TEXTS)
    td, tdm = tc.encode_documents(TEXTS)
    assert tq.dtype == torch.float16 and tq.shape == jq.shape
    np.testing.assert_array_equal(tqm, jqm)
    np.testing.assert_array_equal(tdm, jdm)
    np.testing.assert_allclose(tq.float().numpy(), jq.astype(np.float32), atol=2e-3, rtol=0)
    np.testing.assert_allclose(td.float().numpy(), jd.astype(np.float32), atol=2e-3, rtol=0)


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbge.DenseEmbedder(config=tenc.EncoderConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        tcol.ColBERTEncoder(config=tenc.EncoderConfig.tiny())
