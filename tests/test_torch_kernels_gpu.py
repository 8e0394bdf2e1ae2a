"""The port's CUDA kernels against their plain versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports nothing of JAX, so it runs on a machine that has PyTorch and the
CUDA toolkit only:

    python -m pytest -q -m gpu --noconftest tests/test_torch_kernels_gpu.py

Tolerances: both sides read the same bf16 operands and sum in f32 in
another order — K1 within 1e-4 and K3 within 1e-5 of the score scale.
"""

import numpy as np
import pytest
import torch

from automative_rag_tpu_torch.ops import maxsim as tms
from automative_rag_tpu_torch.ops import sparse_scan as tss

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run `pytest -m gpu` on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("b,lq,dim,ld,n", [(1, 32, 1024, 256, 35), (3, 40, 256, 100, 7),
                                           (2, 8, 64, 16, 130), (8, 32, 1024, 256, 64)])
def test_k1_matches_plain(cuda, b, lq, dim, ld, n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randn((n + 5, ld, dim), generator=gen, device=cuda).to(torch.bfloat16)
    masks = torch.rand((n + 5, ld), generator=gen, device=cuda) > 0.3
    q = torch.randn((b, lq, dim), generator=gen, device=cuda).to(torch.bfloat16)
    q_mask = torch.rand((b, lq), generator=gen, device=cuda) > 0.2
    rows = np.random.default_rng(0).permutation(n + 5)[:n]
    rows[-1] = -1
    got = tms.maxsim_gather_cuda(q, q_mask, tokens, masks, rows)
    want = tms.maxsim_gather_plain(q, q_mask, tokens, masks, rows)
    real = torch.as_tensor(rows >= 0, device=cuda)
    scale = float(want[:, real].abs().max())
    torch.testing.assert_close(got[:, real], want[:, real], rtol=0,
                               atol=1e-4 * max(1.0, scale))
    assert bool((got[:, ~real] < -1e29).all())


def test_k1_rejects_what_it_does_not_take(cuda):
    tokens = torch.zeros((4, 8, 64), dtype=torch.float32, device=cuda)
    masks = torch.ones((4, 8), dtype=torch.bool, device=cuda)
    q = torch.zeros((1, 4, 64), dtype=torch.bfloat16, device=cuda)
    q_mask = torch.ones((1, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        tms.maxsim_gather_cuda(q, q_mask, tokens, masks, [0, 1])
    with pytest.raises(IndexError):
        tms.maxsim_gather_cuda(q, q_mask, tokens.bfloat16(), masks, [0, 4])


def test_k1_scores_out_of_range_card_rows_as_padding(cuda):
    """Row ids on the card are not read back: the kernel itself checks them
    against the store's capacity and scores a bad id as all padding."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randn((6, 40, 64), generator=gen, device=cuda).to(torch.bfloat16)
    masks = torch.ones((6, 40), dtype=torch.bool, device=cuda)
    q = torch.randn((2, 32, 64), generator=gen, device=cuda).to(torch.bfloat16)
    q_mask = torch.ones((2, 32), dtype=torch.bool, device=cuda)
    rows = torch.tensor([3, 6, -7, 1 << 40, 0, -1], device=cuda)
    got = tms.maxsim_gather_cuda(q, q_mask, tokens, masks, rows)
    good = torch.tensor([True, False, False, False, True, False], device=cuda)
    want = tms.maxsim_gather_plain(q, q_mask, tokens, masks, rows.masked_fill(~good, -1))
    torch.testing.assert_close(got[:, good], want[:, good], rtol=0,
                               atol=1e-4 * max(1.0, float(want[:, good].abs().max())))
    assert bool((got[:, ~good] < -1e29).all())


def _slab(rng, t, cap, vocab):
    ids = rng.integers(0, vocab, (t, cap)).astype(np.int32)
    w = rng.random((t, cap)).astype(np.float32)
    pad = rng.random((t, cap)) < 0.2
    ids[pad] = -1
    w[pad] = 0.0
    return ids, w


@pytest.mark.parametrize("q", [8, 32])
@pytest.mark.parametrize("b", [1, 4, 11])
def test_k3_matches_plain(cuda, q, b):
    rng = np.random.default_rng(q * 100 + b)
    ids, w = _slab(rng, 48, 8192, 300)
    q_ids = np.stack([rng.choice(300, q, replace=False) for _ in range(b)]).astype(np.int32)
    q_w = rng.random((b, q)).astype(np.float32)
    q_ids[:, -2:], q_w[:, -2:] = -1, 0.0
    ids_d = torch.from_numpy(ids).to(cuda)
    w_d = torch.from_numpy(w).to(cuda).bfloat16()
    qi, qw = torch.from_numpy(q_ids).to(cuda), torch.from_numpy(q_w).to(cuda)
    got = tss.sparse_scores_tm_cuda(ids_d, w_d, qi, qw)
    want = tss.sparse_scores_tm_plain(ids_d, w_d, qi, qw)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(want.abs().max())))


def test_stores_and_indexes_on_card_match_cpu(cuda):
    """The same rows through the card's stores (kernels) and the CPU's
    (plain versions): MaxSim within 1e-4 of scale (bf16 vs fp16 query),
    sparse hits the same rows with scores within 1e-5."""
    from automative_rag_tpu_torch.index.sparse import SparseIndex
    from automative_rag_tpu_torch.rerank.token_store import TokenStore

    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((40, 64, 128)).astype(np.float32)
    masks = np.arange(64)[None, :] < rng.integers(1, 65, 40)[:, None]
    q = torch.from_numpy(rng.standard_normal((2, 32, 128)).astype(np.float16))
    q_mask = np.ones((2, 32), bool)
    stores = {dev: TokenStore(dim=128, max_doc_length=64, device=dev)
              for dev in ("cpu", cuda)}
    for store in stores.values():
        store.append(tokens, masks)
    rows = [5, 0, 39, 17, 17]
    before = tms.maxsim_gather_cuda.launches
    got = stores[cuda].maxsim_fused(q, q_mask, rows).cpu()
    want = stores["cpu"].maxsim_fused(q.to(torch.bfloat16), q_mask, rows)
    assert tms.maxsim_gather_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))

    ids, w = _slab(rng, 12, 3000, 80)
    idx = {dev: SparseIndex(top_terms=12, device=dev) for dev in ("cpu", cuda)}
    for index in idx.values():
        index.append(ids.T.copy(), w.T.copy())
    before = tss.sparse_scores_tm_cuda.launches
    for _ in range(4):
        q_ids = rng.choice(80, 10, replace=False).astype(np.int32)
        q_w = rng.random(10).astype(np.float32)
        a, b = idx[cuda].search(q_ids, q_w, 12), idx["cpu"].search(q_ids, q_w, 12)
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=1e-5)
    assert tss.sparse_scores_tm_cuda.launches == before + 4


def test_rerank_encoding_on_the_fly_goes_through_k1(cuda):
    """The rerank path without a token store feeds K1 the freshly encoded
    (fp16 → bf16) document tokens; scores agree with the CPU's plain path
    within 1e-2 of their scale (bf16 encoder arithmetic on both sides,
    summed in other orders)."""
    from automative_rag_tpu_torch.documents.schema import Document
    from automative_rag_tpu_torch.models.colbert import ColBERTEncoder
    from automative_rag_tpu_torch.models.encoder import EncoderConfig
    from automative_rag_tpu_torch.rerank.reranker import LateInteractionReranker

    cfg = EncoderConfig.tiny(hidden_size=64)
    enc = {dev: ColBERTEncoder(config=cfg, max_doc_length=64, device=dev)
           for dev in ("cpu", cuda)}
    enc[cuda].model.load_state_dict(enc["cpu"].model.state_dict())
    docs = [Document(page_content=text, metadata={"id": f"d{i}"}) for i, text in
            enumerate(["宝马X5 2022款 SUV 动力强劲", "特斯拉Model 3 续航606公里",
                       "比亚迪汉EV 续航715公里", "丰田凯美瑞 综合油耗4.1升"])]
    before = tms.maxsim_gather_cuda.launches
    got = LateInteractionReranker(enc[cuda]).rerank("汉EV 续航里程", docs)
    want = LateInteractionReranker(enc["cpu"]).rerank("汉EV 续航里程", docs)
    assert tms.maxsim_gather_cuda.launches == before + 1
    by_id = {d.id: s for d, s in want}
    scale = max(abs(s) for _, s in want)
    for doc, score in got:
        assert abs(score - by_id[doc.id]) <= 1e-2 * scale


def test_non_bf16_token_store_on_card_raises(cuda):
    from automative_rag_tpu_torch.rerank.token_store import TokenStore

    with pytest.raises(NotImplementedError, match="bf16"):
        TokenStore(dim=8, max_doc_length=4, device_dtype="float32", device=cuda)
