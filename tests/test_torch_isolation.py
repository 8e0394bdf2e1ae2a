"""The PyTorch port stands alone and never hides the card or a kernel.

- a fresh interpreter imports ``automative_rag_tpu_torch``, runs a tiny
  ingest + query on the CPU, and has imported neither ``jax`` nor
  ``automative_rag_tpu``;
- no module of the port and not ``chip_smoke.py`` imports ``jax``, ``flax``
  or ``automative_rag_tpu`` (checked on the syntax tree);
- every entry point defaults to the card and raises without one;
- kernel wrappers refuse CPU tensors, a missing ``nvcc`` raises, and a
  configured LLM checkpoint raises instead of degrading to the stub.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "automative_rag_tpu_torch"
FORBIDDEN = ("jax", "flax", "automative_rag_tpu")

PROBE = r"""
import json, sys
from automative_rag_tpu_torch.app import RAGApplication
from automative_rag_tpu_torch.config.settings import Settings
app = RAGApplication(settings=Settings(), tiny=True, device="cpu")
out = app.ingest_text("宝马5系 2023款的百公里加速时间为6.9秒。综合油耗7.2升。" * 30,
                      {"manufacturer": "宝马", "model": "5系", "year": 2023})
res = app.query("宝马5系的加速时间是多少", mode="facts")
print(json.dumps({
    "chunks": out["document_count"],
    "answer": res["answer"],
    "cited": res["cited_doc_ids"],
    "jax": [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "flax" or m.startswith("flax.")],
    "reference": [m for m in sys.modules if m == "automative_rag_tpu"
                  or m.startswith("automative_rag_tpu.")],
}, ensure_ascii=False))
"""


def test_subprocess_query_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == [] and out["reference"] == []
    assert out["chunks"] >= 1 and out["cited"] and "【来源：" in out["answer"]


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_entry_points_raise_without_a_card(monkeypatch):
    from automative_rag_tpu_torch.app import RAGApplication
    from automative_rag_tpu_torch.config.settings import Settings
    from automative_rag_tpu_torch.index.flat import FlatIndex
    from automative_rag_tpu_torch.index.sparse import SparseIndex
    from automative_rag_tpu_torch.models.bge_m3 import DenseEmbedder
    from automative_rag_tpu_torch.models.colbert import ColBERTEncoder
    from automative_rag_tpu_torch.models.encoder import EncoderConfig, TransformerEncoder
    from automative_rag_tpu_torch.rerank.token_store import TokenStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RAGApplication()
    with pytest.raises(RuntimeError, match="CUDA"):
        RAGApplication(settings=Settings(), tiny=True)
    for make in (lambda: FlatIndex(dim=8), lambda: SparseIndex(),
                 lambda: TokenStore(dim=8, max_doc_length=4),
                 lambda: TransformerEncoder(EncoderConfig.tiny()),
                 lambda: DenseEmbedder(config=EncoderConfig.tiny()),
                 lambda: ColBERTEncoder(config=EncoderConfig.tiny())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_kernel_wrappers_refuse_cpu_tensors():
    from automative_rag_tpu_torch.ops.maxsim import maxsim_gather_cuda
    from automative_rag_tpu_torch.ops.sparse_scan import sparse_scores_tm_cuda

    with pytest.raises(ValueError, match="CUDA"):
        maxsim_gather_cuda(torch.zeros(1, 4, 8, dtype=torch.bfloat16),
                           torch.ones(1, 4, dtype=torch.bool),
                           torch.zeros(2, 4, 8, dtype=torch.bfloat16),
                           torch.ones(2, 4, dtype=torch.bool), [0, 1])
    with pytest.raises(ValueError, match="CUDA"):
        sparse_scores_tm_cuda(torch.zeros(4, 16, dtype=torch.int32),
                              torch.zeros(4, 16, dtype=torch.bfloat16),
                              torch.zeros(1, 8, dtype=torch.int32),
                              torch.zeros(1, 8))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from automative_rag_tpu_torch import backend

    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(backend.shutil, "which", lambda name: None)
    monkeypatch.setattr(backend, "NVCC_FALLBACK", str(tmp_path / "none"))
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(backend, "_LIBS", {})
    with pytest.raises(backend.KernelBuildError):
        backend.build_kernels(["maxsim"])


def test_llm_checkpoint_raises_and_stub_answers():
    from automative_rag_tpu_torch.generation.llm import StubLLM, load_llm

    assert isinstance(load_llm(""), StubLLM)
    with pytest.raises(NotImplementedError, match="Qwen2"):
        load_llm("/models/qwen2")


def test_ptxas_summary_keeps_registers_and_spills():
    from automative_rag_tpu_torch.backend import _ptxas_summary

    log = ("ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
           "ptxas info    : Function properties for k\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, used 1 barriers\n")
    assert len(_ptxas_summary(log)) == 3


def test_chip_smoke_refuses_without_a_card(tmp_path):
    # alone in a directory, the script finds no package and exits non-zero
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and proc.stdout == ""
