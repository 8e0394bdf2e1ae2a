#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``automative_rag_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the whole run, one card, no arguments

Phases, one JSON line each:

1. ``device``  — card name and count, ``nvidia-smi`` name and power limit,
   CUDA and ``nvcc`` versions.
2. ``build``   — builds every CUDA kernel of the query path from
   ``automative_rag_tpu_torch/csrc`` with ``nvcc`` (``sm_90a``); seconds and
   the ``-Xptxas -v`` summary.
3. ``kernels`` — each kernel against its plain PyTorch version on the card at
   the main path's shapes: max abs error and the stated tolerance, kernel /
   plain / library times (CUDA graphs of many launches timed with CUDA
   events, the inputs rotated so they do not sit in L2), the launches
   made, and the bound.
4. ``main_path`` — ``RAGApplication(tiny=False)`` at bge-m3 width: ingests
   seeded bilingual automotive text (≥ 4096 chunks), answers queries in
   several modes with and without metadata filters, checks every answer
   cites ingested documents and that both kernels were launched; then a
   tiny application on the card and on the CPU (plain versions) answer the
   same queries over the same documents and must agree.
5. ``dense_transformer`` — ``DenseEmbedder(mode="transformer")`` at bge-m3
   width embeds 64 texts; vectors must be finite and unit-norm.

Then the per-kernel summary line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Any failure raises and the run exits
non-zero. No phase runs without a CUDA card, and the script refuses to run
without the package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "automative_rag_tpu_torch"

#: published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate,
#: bf16 tensor-core rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_TC_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

MIN_CHUNKS = 4096
#: the sparse slab [T, cap] the main path builds over MIN_CHUNKS chunks
#: (one 8192-column block); the kernels phase scans one of this shape
SPARSE_SLAB = (48, 8192)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, ensure_ascii=False), flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_graph(fn, reps: int = 16, replays: int = 10) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events — the kernel's
    time without Python's launch overhead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def time_cuda(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call over ``iters`` warm calls between CUDA events,
    Python's launch overhead included (the wrapper as a caller sees it)."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- corpus
VEHICLES = [
    ("比亚迪", "汉EV", "BYD Han EV"), ("比亚迪", "唐DM", "BYD Tang DM"),
    ("比亚迪", "海豹", "BYD Seal"), ("比亚迪", "秦PLUS", "BYD Qin PLUS"),
    ("吉利", "星越L", "Geely Monjaro"), ("吉利", "几何A", "Geometry A"),
    ("长城", "坦克300", "Tank 300"), ("长城", "哈弗H6", "Haval H6"),
    ("蔚来", "ES6", "NIO ES6"), ("蔚来", "ET5", "NIO ET5"),
    ("理想", "L9", "Li Auto L9"), ("理想", "L7", "Li Auto L7"),
    ("小鹏", "P7", "XPeng P7"), ("小鹏", "G9", "XPeng G9"),
    ("宝马", "X5", "BMW X5"), ("宝马", "3系", "BMW 3 Series"),
    ("宝马", "5系", "BMW 5 Series"), ("奔驰", "E级", "Mercedes E-Class"),
    ("奔驰", "GLC", "Mercedes GLC"), ("奥迪", "A6L", "Audi A6L"),
    ("奥迪", "Q5L", "Audi Q5L"), ("特斯拉", "Model 3", "Tesla Model 3"),
    ("特斯拉", "Model Y", "Tesla Model Y"), ("丰田", "凯美瑞", "Toyota Camry"),
    ("丰田", "RAV4", "Toyota RAV4"), ("本田", "雅阁", "Honda Accord"),
    ("本田", "CR-V", "Honda CR-V"), ("大众", "迈腾", "VW Magotan"),
    ("大众", "ID.4", "VW ID.4"), ("大众", "途观L", "VW Tiguan L"),
]

ADJ_ZH = ["出色", "一般", "优秀", "令人满意", "有待提升", "中规中矩"]
ADJ_EN = ["composed", "lively", "quiet", "firm", "relaxed", "agile"]
PROS = ["空间宽敞", "加速迅猛", "油耗低", "智能座舱流畅", "底盘扎实", "隔音好"]
CONS = ["后排头部空间紧张", "车机反应慢", "悬挂偏硬", "售价偏高", "风噪明显", "保养贵"]
FEATURES_EN = ["wireless CarPlay", "adaptive cruise control", "a 360-degree camera",
               "over-the-air updates", "a heat pump", "lane centering assist"]


def vehicle_text(rng, manu: str, model: str, model_en: str, year: int,
                 n_sentences: int) -> str:
    def pick(options):
        return options[int(rng.integers(len(options)))]

    templates = [
        lambda: f"{manu}{model} {year}款的百公里加速时间为{rng.uniform(3.5, 11.0):.1f}秒。",
        lambda: f"{model}的CLTC续航里程为{int(rng.integers(400, 1000))}公里，电池容量{int(rng.integers(50, 120))}千瓦时。",
        lambda: f"The {year} {model_en} delivers {int(rng.integers(150, 700))} horsepower and {int(rng.integers(250, 900))} Nm of torque.",
        lambda: f"{model}的综合油耗为{rng.uniform(4.0, 11.0):.1f}升/百公里，最高时速{int(rng.integers(170, 260))}公里。",
        lambda: f"车主评价：{model}的座椅舒适，隔音表现{pick(ADJ_ZH)}，整体驾驶感受{pick(ADJ_ZH)}。",
        lambda: f"{model}轴距{int(rng.integers(2600, 3200))}毫米，后备箱容积{int(rng.integers(380, 700))}升。",
        lambda: f"优点：{pick(PROS)}。缺点：{pick(CONS)}。",
        lambda: f"In daily commuting the {model_en} feels {pick(ADJ_EN)}, and it offers {pick(FEATURES_EN)}.",
        lambda: f"{manu}为{model}提供{int(rng.integers(3, 8))}年或{int(rng.integers(10, 20))}万公里质保，售价{rng.uniform(15, 90):.2f}万元起。",
    ]
    return "".join(templates[int(rng.integers(len(templates)))]() for _ in range(n_sentences))


def corpus(seed: int = 0, n_texts: int = 800, n_sentences: int = 220):
    """Seeded (content, metadata) pairs: one vehicle and model year each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for i in range(n_texts):
        manu, model, model_en = VEHICLES[i % len(VEHICLES)]
        year = int(rng.integers(2019, 2025))
        yield (vehicle_text(rng, manu, model, model_en, year, n_sentences),
               {"manufacturer": manu, "model": model, "year": year,
                "title": f"{year} {model_en} review"})


QUERIES = [
    ("比亚迪汉EV的续航里程是多少", "facts", None),
    ("宝马X5的百公里加速时间", "facts", {"manufacturer": "宝马"}),
    ("Tesla Model Y horsepower and torque", "facts", None),
    ("哪款SUV的后备箱容积最大", "features", {"year": 2023}),
    ("理想L9的座椅舒适吗", "features", None),
    ("小鹏P7的综合油耗", "tradeoffs", {"manufacturer": ["小鹏", "蔚来"]}),
    ("蔚来ES6的优点和缺点", "tradeoffs", None),
    ("丰田凯美瑞的油耗", "facts", {"year": {"gte": 2020, "lte": 2022}}),
    ("坦克300的扭矩", "features", None),
    ("宝马3系的轴距是多少", "facts", {"manufacturer": "宝马"}),
]


# -------------------------------------------------------------- phases
def phase_device() -> dict:
    import torch

    from automative_rag_tpu_torch.backend import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi_name_power(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": (nvcc.stdout.strip().splitlines() or ["?"])[-1],
    }
    emit("device", **info)
    return info


def phase_build() -> None:
    from automative_rag_tpu_torch.backend import build_kernels

    t0 = time.perf_counter()
    info = build_kernels()
    emit("build", seconds=time.perf_counter() - t0, kernels=info)


def phase_kernels() -> dict:
    """Each kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch

    from automative_rag_tpu_torch.ops import maxsim as ms
    from automative_rag_tpu_torch.ops import sparse_scan as ss

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    results = {"maxsim": [], "sparse_scan": []}

    # K1: a store of 4096 docs x 256 tokens x 1024 (2 GiB bf16), LayerNorm-
    # scaled values, real-token prefixes of random length
    cap, ld, dim, lq = 4096, 256, 1024, 32
    tokens = torch.randn((cap, ld, dim), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.as_tensor(rng.integers(16, ld + 1, cap), device=dev)
    masks = torch.arange(ld, device=dev)[None, :] < lengths[:, None]
    for n_cand in (35, 128):
        q = torch.randn((1, lq, dim), generator=gen, device=dev).to(torch.bfloat16)
        q_mask = torch.zeros((1, lq), dtype=torch.bool, device=dev)
        q_mask[:, 1:20] = True
        # rotate through 16 candidate sets so each launch streams cold slabs
        row_sets = [rng.choice(cap, n_cand, replace=False) for _ in range(16)]
        row_sets[0][-1] = -1  # one padding candidate (all tokens masked)
        launches0 = ms.maxsim_gather_cuda.launches
        got = ms.maxsim_gather_cuda(q, q_mask, tokens, masks, row_sets[0])
        want = ms.maxsim_gather_plain(q, q_mask, tokens, masks, row_sets[0])
        torch.cuda.synchronize()
        real = torch.as_tensor(row_sets[0] >= 0, device=dev)[None, :]
        err = float((got - want)[real].abs().max())
        scale = float(want[real].abs().max())
        tol = 1e-4 * max(1.0, scale)  # f32 sums in another order
        if not bool(torch.isfinite(got).all()) or err > tol:
            raise AssertionError(f"K1 N={n_cand}: max abs err {err} > {tol}")
        # the padding candidate sinks (-1e30 per weighted query token) in both
        if not (float(got[~real].max()) < -1e29 and float(want[~real].max()) < -1e29):
            raise AssertionError(f"K1 N={n_cand}: padding candidate did not sink")

        rows_dev = [torch.as_tensor(r, device=dev) for r in row_sets]

        def library(i):
            # cuBLAS bf16 batched product + bias + max + weighted sum
            r = rows_dev[i % 16].clamp(min=0)
            docs = tokens[r]
            sim = torch.matmul(q[0], docs.transpose(1, 2)).float()  # [N, Lq, Ld]
            sim = sim + torch.where(masks[r], 0.0, ms.NEG_BIAS)[:, None, :]
            return (sim.amax(-1) * q_mask[0].float()).sum(-1)

        k_ms = time_graph(lambda i: ms.maxsim_gather_cuda(q, q_mask, tokens, masks, rows_dev[i % 16]))
        p_ms = time_graph(lambda i: ms.maxsim_gather_plain(q, q_mask, tokens, masks, rows_dev[i % 16]))
        l_ms = time_graph(library)
        # the store's call: host rows through the wrapper, overhead included
        w_ms = time_cuda(lambda i: ms.maxsim_gather(q, q_mask, tokens, masks, row_sets[i % 16]))
        # the least work this data needs, per call averaged over the timed
        # candidate sets: the real tokens of each candidate (read once)
        # against the scored query tokens; masks, query, rows, scores once
        real_tokens = sum(int(masks[torch.as_tensor(r[r >= 0], device=dev)].sum())
                          for r in row_sets) / len(row_sets)
        scored = int(q_mask.sum())
        nbytes = (real_tokens * dim * 2 + n_cand * ld + lq * dim * 2 + lq
                  + n_cand * 8 + n_cand * 4)
        ops = 2 * scored * dim * real_tokens
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_TC_OPS_PER_S * 1e3
        results["maxsim"].append({
            "B": 1, "Lq": lq, "D": dim, "Ld": ld, "N": n_cand,
            "max_abs_err": err, "tolerance": tol, "kernel_ms": k_ms,
            "plain_ms": p_ms, "library_ms": l_ms, "wrapper_ms": w_ms,
            "launches": ms.maxsim_gather_cuda.launches - launches0,
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
    del tokens, masks, rows_dev
    torch.cuda.empty_cache()

    # K3/K3b: the smoke corpus's slab (T=48, cap = one 8192-column block),
    # Zipf-like term ids so matches happen, ~15% pad columns
    n_terms, cap = SPARSE_SLAB
    ids = torch.as_tensor(
        np.minimum(rng.zipf(1.3, (n_terms, cap)), 50000).astype(np.int32), device=dev)
    w = torch.rand((n_terms, cap), generator=gen, device=dev).to(torch.bfloat16)
    pad = torch.as_tensor(rng.random((n_terms, cap)) < 0.15, device=dev)
    ids = torch.where(pad, -1, ids).contiguous()
    w = torch.where(pad, 0.0, w.float()).to(torch.bfloat16).contiguous()
    # 24 copies (57 MB) rotated through in the timings, so the slab is not
    # served from the 50 MB L2 on every launch
    copies = [(ids.clone(), w.clone()) for _ in range(24)]
    for n_q in (8, 32):
        for b in (1, 4):
            q_ids = torch.as_tensor(
                np.minimum(rng.zipf(1.3, (b, n_q)), 50000).astype(np.int32), device=dev)
            q_w = torch.rand((b, n_q), generator=gen, device=dev)
            launches0 = ss.sparse_scores_tm_cuda.launches
            got = ss.sparse_scores_tm_cuda(ids, w, q_ids, q_w)
            want = ss.sparse_scores_tm_plain(ids, w, q_ids, q_w)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = 1e-5 * max(1.0, float(want.abs().max()))  # f32, other order
            if err > tol:
                raise AssertionError(f"K3 Q={n_q} B={b}: max abs err {err} > {tol}")
            k_ms = time_graph(lambda i: ss.sparse_scores_tm_cuda(*copies[i % 24], q_ids, q_w), reps=24)
            p_ms = time_graph(lambda i: ss.sparse_scores_tm_plain(*copies[i % 24], q_ids, q_w), reps=24, replays=3)
            q_host = (q_ids.cpu().numpy(), q_w.cpu().numpy())
            w_ms = time_cuda(lambda i: ss.sparse_scores_tm_batch(*copies[i % 24], *q_host), iters=48)
            nbytes = n_terms * cap * 6 + b * n_q * 8 + b * cap * 4
            ops = 2 * b * n_terms * cap * n_q
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            results["sparse_scan"].append({
                "T": n_terms, "cap": cap, "Q": n_q, "B": b,
                "max_abs_err": err, "tolerance": tol, "kernel_ms": k_ms,
                "plain_ms": p_ms, "library_ms": None, "wrapper_ms": w_ms,
                "launches": ss.sparse_scores_tm_cuda.launches - launches0,
                "bytes": nbytes, "ops": ops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            })
    emit("kernels", **results)
    return results


def _cited_ids(result: dict) -> set:
    by_label = {s["doc_id"]: s["id"] for s in result["sources"]}
    return {by_label.get(label) for label in result["cited_doc_ids"]}


def phase_main_path() -> dict:
    import numpy as np
    import torch

    from automative_rag_tpu_torch.app import RAGApplication
    from automative_rag_tpu_torch.config.settings import Settings
    from automative_rag_tpu_torch.ops.maxsim import maxsim_gather_cuda
    from automative_rag_tpu_torch.ops.sparse_scan import sparse_scores_tm_cuda

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    app = RAGApplication(settings=Settings(), tiny=False, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    maxsim_gather_cuda.launches = 0
    sparse_scores_tm_cuda.launches = 0

    t0 = time.perf_counter()
    ingested, chunks, texts = set(), 0, 0
    for content, meta in corpus():
        out = app.ingest_text(content, meta)
        ingested.update(out["document_ids"])
        chunks += out["document_count"]
        texts += 1
        if chunks >= MIN_CHUNKS:
            break
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if chunks < MIN_CHUNKS:
        raise AssertionError(f"only {chunks} chunks ingested")
    ingest_launches = {"maxsim": maxsim_gather_cuda.launches,
                       "sparse_scan": sparse_scores_tm_cuda.launches}

    latencies, per_query = [], []
    for query, mode, flt in QUERIES:
        t1 = time.perf_counter()
        result = app.query(query, mode=mode, metadata_filter=flt)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t1)
        cited = _cited_ids(result)
        if not cited or "【来源：" not in result["answer"]:
            raise AssertionError(f"no citation in the answer to {query!r}: {result['answer'][:200]}")
        if not cited <= ingested:
            raise AssertionError(f"answer to {query!r} cites unknown ids {cited - ingested}")
        per_query.append({"query": query, "mode": mode, "filter": flt,
                          "seconds": latencies[-1], "cited": len(cited),
                          "documents": len(result["documents"]),
                          "timings": result["retrieval_timings"]})
    launches = {"maxsim": maxsim_gather_cuda.launches,
                "sparse_scan": sparse_scores_tm_cuda.launches}
    if any(launches[k] <= ingest_launches[k] for k in launches):
        raise AssertionError(f"a kernel was not launched by the queries: "
                             f"{ingest_launches} after ingest, {launches} after the queries")
    slab = tuple(app.sparse_index._device[0].shape)
    if slab != SPARSE_SLAB:
        raise AssertionError(f"the main path's sparse slab is {slab}, the kernels "
                             f"phase measured K3 on {SPARSE_SLAB}")

    emit("main_path", model="bge-m3 width (random init, seeded)",
         build_s=build_s, texts=texts, chunks=chunks, ingest_s=ingest_s,
         chunks_per_s=chunks / ingest_s, queries=len(QUERIES),
         modes=sorted({m for _, m, _ in QUERIES}),
         p50_query_s=float(np.median(latencies)), max_query_s=max(latencies),
         launches=launches, ingest_launches=ingest_launches, per_query=per_query,
         token_store_rows=app.token_store.rows,
         sparse_slab=list(slab),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del app
    torch.cuda.empty_cache()
    return launches


def phase_small_agreement() -> dict:
    """A tiny application on the card (kernels) and on the CPU (plain
    versions) over the same documents must return the same top document
    and largely the same ranked list."""
    import dataclasses

    from automative_rag_tpu_torch.app import RAGApplication
    from automative_rag_tpu_torch.config.settings import Settings
    from automative_rag_tpu_torch.documents.schema import Document

    apps = {dev: RAGApplication(settings=Settings(), tiny=True, device=dev)
            for dev in ("cpu", "cuda")}
    state = apps["cpu"].colbert.model.state_dict()
    apps["cuda"].colbert.model.load_state_dict(state)
    docs = []
    for i, (content, meta) in enumerate(corpus(seed=1, n_texts=24, n_sentences=6)):
        docs.append(Document(page_content=content, metadata={**meta, "id": f"doc-{i}"}))
    for app in apps.values():
        app.generate_embeddings([dataclasses.replace(d, metadata=dict(d.metadata)) for d in docs])
    rows = []
    for query, mode, flt in QUERIES[:6]:
        ranked = {dev: app.engine.retrieve(query, mode=mode, metadata_filter=flt)
                  for dev, app in apps.items()}
        ids = {dev: [d.id for d, _ in r] for dev, r in ranked.items()}
        overlap = len(set(ids["cpu"]) & set(ids["cuda"])) / max(1, len(ids["cpu"]))
        rows.append({"query": query, "top_equal": ids["cpu"][:1] == ids["cuda"][:1],
                     "overlap": overlap})
        # tolerance: the card feeds K1 bf16 query tokens, the CPU path fp16
        if ids["cpu"][:1] != ids["cuda"][:1] or overlap < 0.8:
            raise AssertionError(f"card and CPU disagree on {query!r}: {ids}")
    return {"queries": rows}


def phase_dense_transformer() -> None:
    import torch

    from automative_rag_tpu_torch.models.bge_m3 import DenseEmbedder
    from automative_rag_tpu_torch.models.encoder import EncoderConfig

    t0 = time.perf_counter()
    emb = DenseEmbedder(config=EncoderConfig.bge_m3(), mode="transformer", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    texts = [c[:600] for c, _ in corpus(seed=2, n_texts=64, n_sentences=20)]
    timings = []
    for _ in range(2):
        t1 = time.perf_counter()
        vecs = emb.embed_texts(texts)
        torch.cuda.synchronize()
        timings.append(time.perf_counter() - t1)
    norms = (vecs ** 2).sum(axis=1) ** 0.5
    import numpy as np

    if vecs.shape != (64, 1024) or not np.isfinite(vecs).all():
        raise AssertionError(f"bad dense vectors {vecs.shape}")
    if float(np.abs(norms - 1).max()) > 1e-3:
        raise AssertionError(f"vectors not unit-norm: {norms.min()}..{norms.max()}")
    emit("dense_transformer", texts=64, dim=1024, init_s=init_s,
         first_embed_s=timings[0], warm_embed_s=timings[1],
         max_norm_err=float(np.abs(norms - 1).max()))


def main() -> int:
    if not (PKG / "__init__.py").exists():
        print("chip_smoke: automative_rag_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device()
    phase_build()
    kern = phase_kernels()
    launches = phase_main_path()
    emit("small_agreement", **phase_small_agreement())
    phase_dense_transformer()

    k1 = kern["maxsim"][0]  # the main path's shape: B=1, N=35
    k3 = next(r for r in kern["sparse_scan"] if r["B"] == 1 and r["Q"] == 32)
    summary = {"kernels": [
        {"name": "maxsim", "route": "cuda",
         "source": "automative_rag_tpu_torch/csrc/maxsim.cu",
         "replaces": "automative_rag_tpu/ops/maxsim.py:67",
         "launches": launches["maxsim"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "sparse_scan", "route": "cuda",
         "source": "automative_rag_tpu_torch/csrc/sparse_scan.cu",
         "replaces": "automative_rag_tpu/ops/sparse_scan.py:41",
         "launches": launches["sparse_scan"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
    ]}
    print(json.dumps(summary), flush=True)
    print(smi_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
