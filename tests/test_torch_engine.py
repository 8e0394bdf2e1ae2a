"""The whole query path: the PyTorch port's retrieval engine and answer against
the JAX package's, over the same documents.

Both engines are assembled alike from tiny configs: lexical dense
embedder, flat bf16 index, ColBERT token store + MaxSim rerank (the JAX
ColBERT's random parameters carried over with ``load_flax_params``, both
in f32, JAX under ``default_matmul_precision("highest")``), and the sparse
arm; the JAX engine runs its per-stage path (``fused_path=False``). For
several modes, filtered and unfiltered, ``retrieve()`` must return the
same document ids in the same order with scores within 1e-4 (normalized
scores in [0.35, 1]; MaxSim sums in another order), and the extractive
answer must be the same text.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automative_rag_tpu.documents.schema import Document as JDocument
from automative_rag_tpu.engine.retrieval import RetrievalEngine as JEngine
from automative_rag_tpu.generation.llm import AnswerGenerator as JAnswer
from automative_rag_tpu.index.flat import FlatIndex as JFlat
from automative_rag_tpu.index.sparse import SparseIndex as JSparseIndex
from automative_rag_tpu.models.bge_m3 import DenseEmbedder as JDense
from automative_rag_tpu.models.colbert import ColBERTEncoder as JColBERT
from automative_rag_tpu.models.encoder import EncoderConfig as JConfig
from automative_rag_tpu.models.sparse import SparseEncoder as JSparseEncoder
from automative_rag_tpu.rerank.reranker import LateInteractionReranker as JReranker
from automative_rag_tpu.rerank.token_store import TokenStore as JTokenStore
from automative_rag_tpu_torch.documents.schema import Document as TDocument
from automative_rag_tpu_torch.engine.retrieval import RetrievalEngine as TEngine
from automative_rag_tpu_torch.generation.llm import AnswerGenerator as TAnswer
from automative_rag_tpu_torch.index.flat import FlatIndex as TFlat
from automative_rag_tpu_torch.index.sparse import SparseIndex as TSparseIndex
from automative_rag_tpu_torch.models.bge_m3 import DenseEmbedder as TDense
from automative_rag_tpu_torch.models.colbert import ColBERTEncoder as TColBERT
from automative_rag_tpu_torch.models.encoder import EncoderConfig as TConfig
from automative_rag_tpu_torch.models.sparse import SparseEncoder as TSparseEncoder
from automative_rag_tpu_torch.rerank.reranker import LateInteractionReranker as TReranker
from automative_rag_tpu_torch.rerank.token_store import TokenStore as TTokenStore

SCORE_ATOL = 1e-4

DOCS = [
    ("宝马5系 2023款的百公里加速时间为6.9秒，综合油耗7.2升。", "宝马", "5系", 2023),
    ("宝马X5 2022款 SUV 动力强劲，3.0T发动机输出381马力。", "宝马", "X5", 2022),
    ("奔驰E级 2023款 舒适豪华，后排空间宽敞，隔音出色。", "奔驰", "E级", 2023),
    ("特斯拉Model 3 2023款 纯电动，CLTC续航里程606公里。", "特斯拉", "Model 3", 2023),
    ("丰田凯美瑞 2021款 混合动力，综合油耗4.1升/百公里。", "丰田", "凯美瑞", 2021),
    ("Tesla Model Y 2022 electric SUV, range 545 km and 0-100 in 5.0 s.", "特斯拉", "Model Y", 2022),
    ("比亚迪汉EV 续航715公里，刀片电池安全性优秀。优点：加速快。缺点：车机慢。", "比亚迪", "汉EV", 2023),
    ("蔚来ES6 支持换电，续航610公里，车主评价座椅舒适。", "蔚来", "ES6", 2022),
    ("理想L9 增程式SUV，综合续航1315公里，后备箱容积大。", "理想", "L9", 2023),
    ("小鹏P7 的智能驾驶辅助表现出色，但悬挂偏硬。", "小鹏", "P7", 2021),
    ("宝马3系 2021款 操控灵活，轴距2851毫米。", "宝马", "3系", 2021),
    ("本田雅阁 2022款 油耗低，空间宽敞，保值率高。", "本田", "雅阁", 2022),
] * 2  # near-duplicate pairs exercise tie handling

QUERIES = [
    ("宝马5系的加速时间是多少", "facts", None),
    ("续航里程最长的电动车", "features", None),
    ("油耗低的混合动力车", "tradeoffs", {"year": {"gte": 2021, "lte": 2022}}),
    ("Tesla Model Y range", "facts", {"manufacturer": "特斯拉"}),
    ("座椅舒适吗 空间", "debate", {"manufacturer": ["蔚来", "奔驰", "本田"]}),
    ("汉EV 的优点和缺点", "tradeoffs", None),
]


def _docs(cls):
    return [cls(page_content=text, metadata={"id": f"doc-{i}", "manufacturer": manu,
                                              "model": model, "year": year,
                                              "source_id": f"src-{i % 12}"})
            for i, (text, manu, model, year) in enumerate(DOCS)]


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(JConfig.tiny(hidden_size=64), dtype=jnp.float32)
    tcfg = dataclasses.replace(TConfig.tiny(hidden_size=64), dtype=torch.float32)
    with jax.default_matmul_precision("highest"):
        jd = JDense(config=jcfg, max_length=128)
        jc = JColBERT(config=jcfg, max_query_length=32, max_doc_length=64)
        jeng = JEngine(jd, JFlat(dim=64), JReranker(jc),
                       token_store=JTokenStore(dim=64, max_doc_length=64),
                       sparse_index=JSparseIndex(top_terms=24),
                       sparse_encoder=JSparseEncoder(jd, top_terms=24, query_terms=16))
        jeng.fused_path = False
        jeng.sparse_index.scan_variant = "fori"
        jdocs = _docs(JDocument)
        jeng.add_documents(jdocs[:16])
        jeng.add_documents(jdocs[16:])
    td = TDense(config=tcfg, max_length=128, device="cpu")
    tc = TColBERT(config=tcfg, max_query_length=32, max_doc_length=64,
                  device="cpu").load_flax_params(jax.device_get(jc.params))
    teng = TEngine(td, TFlat(dim=64, device="cpu"), TReranker(tc),
                   token_store=TTokenStore(dim=64, max_doc_length=64, device="cpu"),
                   sparse_index=TSparseIndex(top_terms=24, device="cpu"),
                   sparse_encoder=TSparseEncoder(td, top_terms=24, query_terms=16))
    tdocs = _docs(TDocument)
    teng.add_documents(tdocs[:16])
    teng.add_documents(tdocs[16:])
    return jeng, teng


def _retrieve_jax(engine, *args, **kwargs):
    with jax.default_matmul_precision("highest"):
        return engine.retrieve(*args, **kwargs)


def _same_ranked(got, want):
    assert [d.id for d, _ in got] == [d.id for d, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("query,mode,flt", QUERIES, ids=[q[0] for q in QUERIES])
def test_retrieve_matches_jax(engines, query, mode, flt):
    jeng, teng = engines
    want = _retrieve_jax(jeng, query, mode=mode, metadata_filter=flt)
    got = teng.retrieve(query, mode=mode, metadata_filter=flt)
    assert got, "empty retrieval"
    _same_ranked(got, want)
    assert teng.last_timings["candidates"] == jeng.last_timings["candidates"]
    assert (teng.last_timings.get("sparse_candidates")
            == jeng.last_timings.get("sparse_candidates"))


@pytest.mark.parametrize("query,mode,flt", QUERIES[:4], ids=[q[0] for q in QUERIES[:4]])
def test_answer_text_matches_jax(engines, query, mode, flt):
    jeng, teng = engines
    want = JAnswer().answer(query, _retrieve_jax(jeng, query, mode=mode, metadata_filter=flt),
                            mode=mode)
    got = TAnswer().answer(query, teng.retrieve(query, mode=mode, metadata_filter=flt),
                           mode=mode)
    assert got["answer"] == want["answer"]
    assert "【来源：" in got["answer"]
    assert got["cited_doc_ids"] == want["cited_doc_ids"]
    assert [s["id"] for s in got["sources"]] == [s["id"] for s in want["sources"]]


def test_rerank_off_fusion_matches_jax(engines):
    jeng, teng = engines
    for query, mode, flt in QUERIES[:3]:
        want = _retrieve_jax(jeng, query, mode=mode, metadata_filter=flt, rerank=False)
        _same_ranked(teng.retrieve(query, mode=mode, metadata_filter=flt, rerank=False), want)


def test_retrieve_batch_matches_jax(engines):
    jeng, teng = engines
    queries = [q for q, _, _ in QUERIES]
    filters = [f for _, _, f in QUERIES]
    with jax.default_matmul_precision("highest"):
        want = jeng.retrieve_batch(queries, mode="features", metadata_filters=filters)
    got = teng.retrieve_batch(queries, mode="features", metadata_filters=filters)
    for g, w in zip(got, want):
        _same_ranked(g, w)


def test_cache_hits_and_fingerprint(engines):
    _, teng = engines
    teng.retrieve("宝马X5 动力", mode="facts")
    hits = teng.cache_stats["hits"]
    teng.retrieve("宝马X5 动力", mode="facts")
    assert teng.cache_stats["hits"] == hits + 1 and teng.last_timings.get("cached")
