"""Global settings for the PyTorch/CUDA RAG framework.

Functional parity target: the env-driven knob families of the reference's
``src/config/settings.py`` (retrieval depths, rerank weights, chunking,
sequence lengths, batch sizes, model paths), re-expressed for a TPU engine:
instead of per-GPU-worker memory fractions there are mesh/layout knobs.

Everything is read from environment variables once at import, with sane
defaults, and is overridable at runtime through ``Settings.update`` (the
equivalent of the reference's ``/model/update-config`` mutable config file).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, asdict, fields
from pathlib import Path
from typing import Any, Optional


def _env(name: str, default: Any, cast=None):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if cast is None:
        cast = type(default) if default is not None else str
    try:
        return cast(raw)
    except (TypeError, ValueError):
        return default


@dataclass
class Settings:
    # --- service ---
    host: str = field(default_factory=lambda: _env("API_HOST", "0.0.0.0"))
    port: int = field(default_factory=lambda: _env("API_PORT", 8000))
    api_auth_enabled: bool = field(
        default_factory=lambda: _env("API_AUTH_ENABLED", False, bool)
    )
    api_key: str = field(default_factory=lambda: _env("API_KEY", "default-api-key"))

    # --- paths ---
    data_dir: str = field(default_factory=lambda: _env("DATA_DIR", "data"))
    models_dir: str = field(default_factory=lambda: _env("MODELS_DIR", "models"))
    index_dir: str = field(default_factory=lambda: _env("INDEX_DIR", "data/index"))
    upload_dir: str = field(default_factory=lambda: _env("UPLOAD_DIR", "data/uploads"))
    media_cache_dir: str = field(
        default_factory=lambda: _env("MEDIA_CACHE_DIR", "data/media")
    )

    # --- embedding model (bge-m3-compatible dense encoder) ---
    embedding_model_path: str = field(
        default_factory=lambda: _env("EMBEDDING_MODEL_PATH", "")
    )
    embedding_dim: int = field(default_factory=lambda: _env("EMBEDDING_DIM", 1024))
    embedding_batch_size: int = field(
        default_factory=lambda: _env("EMBEDDING_BATCH_SIZE", 64)
    )
    embedding_max_length: int = field(
        default_factory=lambda: _env("EMBEDDING_MAX_LENGTH", 512)
    )

    # --- ColBERT late-interaction reranker ---
    colbert_model_path: str = field(
        default_factory=lambda: _env("COLBERT_MODEL_PATH", "")
    )
    # bge-reranker-class cross-encoder (hybrid second scorer)
    reranker_model_path: str = field(
        default_factory=lambda: _env("RERANKER_MODEL_PATH", "")
    )
    colbert_dim: int = field(default_factory=lambda: _env("COLBERT_DIM", 1024))
    colbert_max_query_length: int = field(
        default_factory=lambda: _env("COLBERT_MAX_QUERY_LENGTH", 32)
    )
    colbert_max_doc_length: int = field(
        default_factory=lambda: _env("COLBERT_MAX_DOC_LENGTH", 256)
    )
    colbert_batch_size: int = field(
        default_factory=lambda: _env("COLBERT_BATCH_SIZE", 128)
    )
    # hybrid combine weights (reference: settings.py:88-89 — 0.8 / 0.2)
    colbert_weight: float = field(default_factory=lambda: _env("COLBERT_WEIGHT", 0.8))
    bge_weight: float = field(default_factory=lambda: _env("BGE_WEIGHT", 0.2))
    use_bge_reranker: bool = field(
        default_factory=lambda: _env("USE_BGE_RERANKER", True, bool)
    )

    # --- retrieval ---
    retriever_top_k: int = field(default_factory=lambda: _env("RETRIEVER_TOP_K", 20))
    reranker_top_k: int = field(default_factory=lambda: _env("RERANKER_TOP_K", 8))
    chunk_size: int = field(default_factory=lambda: _env("CHUNK_SIZE", 1000))
    chunk_overlap: int = field(default_factory=lambda: _env("CHUNK_OVERLAP", 200))

    # --- index engine ---
    index_kind: str = field(default_factory=lambda: _env("INDEX_KIND", "flat"))
    index_dtype: str = field(default_factory=lambda: _env("INDEX_DTYPE", "bfloat16"))
    ivf_n_lists: int = field(default_factory=lambda: _env("IVF_N_LISTS", 0))  # 0=auto
    ivf_n_probe: int = field(default_factory=lambda: _env("IVF_N_PROBE", 16))
    # "budget": variable-length lists probed to a scanned-row budget
    # (distribution-robust — the r05 default); "table": legacy balanced
    # padded list table (supports refine_dims two-stage probing)
    ivf_probe_mode: str = field(
        default_factory=lambda: _env("IVF_PROBE_MODE", "budget"))
    # >0 → probes beyond ivf_n_probe screen on this many head dims, then
    # exact-rescore a shortlist (coarse-then-refine; cheap high-recall mode)
    ivf_refine_dims: int = field(
        default_factory=lambda: _env("IVF_REFINE_DIMS", 0))
    ivf_refine_shortlist: int = field(
        default_factory=lambda: _env("IVF_REFINE_SHORTLIST", 2048))
    # after a rebuild, self-measure recall@k on sampled corpus rows and set
    # n_probe to the smallest ladder width hitting this target (0 disables;
    # power-law/anisotropic corpora under-probe at any fixed default)
    ivf_calibrate_recall: float = field(
        default_factory=lambda: _env("IVF_CALIBRATE_RECALL", 0.95, float))
    # approximate SHORTLIST selection (TPU-native lax.approx_max_k) for the
    # refined quantized flat scan — the host refine rescores it exactly, so
    # this trades nothing measurable for removing the exact-top-k stage
    # that dominates huge scans (BENCH_TOPK_AB_r04)
    index_topk_approx: bool = field(
        default_factory=lambda: _env("INDEX_TOPK_APPROX", True, bool))
    # store ColBERT token embeddings at ingest (rerank-from-store fast path)
    store_token_embeddings: bool = field(
        default_factory=lambda: _env("STORE_TOKEN_EMBEDDINGS", True, bool)
    )
    token_store_device_budget_mb: int = field(
        default_factory=lambda: _env("TOKEN_STORE_DEVICE_BUDGET_MB", 4096)
    )
    token_store_quantize: str = field(
        default_factory=lambda: _env("TOKEN_STORE_QUANTIZE", "none")
    )
    # row-shard the token store over the mesh (rerank-from-store at corpus
    # sizes past one chip's HBM); needs a sharded index kind or >1 device
    token_store_sharded: bool = field(
        default_factory=lambda: _env("TOKEN_STORE_SHARDED", False, bool)
    )

    # --- sparse (lexical) retrieval arm — bge-m3's third head ---
    # exact-term top-k unioned into the dense candidates pre-rerank
    # (models/sparse.py, index/sparse.py); weightless deploys get
    # idf-weighted lexical matching, real checkpoints the learned head
    sparse_enabled: bool = field(
        default_factory=lambda: _env("SPARSE_ENABLED", True, bool)
    )
    sparse_top_terms: int = field(
        default_factory=lambda: _env("SPARSE_TOP_TERMS", 48)
    )
    sparse_query_terms: int = field(
        default_factory=lambda: _env("SPARSE_QUERY_TERMS", 32)
    )
    # lexical candidates unioned per query / fusion weight on the
    # rerank-off path (min-max combine, reference rerankers.py idiom)
    sparse_k: int = field(default_factory=lambda: _env("SPARSE_K", 10))
    sparse_weight: float = field(
        default_factory=lambda: _env("SPARSE_WEIGHT", 0.3)
    )
    # share of the FINAL reranked combine carried by the lexical score
    # (bge-m3 hybrid idiom: dense/sparse/multi-vector weighted sum, sparse
    # ≈ 0.2 — exact-term matches lift near-duplicate trims/spec codes the
    # contextual MaxSim blurs)
    sparse_rerank_weight: float = field(
        default_factory=lambda: _env("SPARSE_RERANK_WEIGHT", 0.2)
    )
    # repeated-query retrieval cache entries (0 disables); entries carry a
    # state fingerprint so any corpus/config mutation self-invalidates
    retrieval_cache_size: int = field(
        default_factory=lambda: _env("RETRIEVAL_CACHE_SIZE", 256)
    )

    # --- mesh / parallel layout ---
    mesh_data_axis: int = field(default_factory=lambda: _env("MESH_DATA_AXIS", 0))
    mesh_shard_axis_name: str = field(
        default_factory=lambda: _env("MESH_SHARD_AXIS_NAME", "shard")
    )

    # --- LLM ---
    llm_model_path: str = field(default_factory=lambda: _env("LLM_MODEL_PATH", ""))
    llm_max_tokens: int = field(default_factory=lambda: _env("LLM_MAX_TOKENS", 512))
    llm_temperature: float = field(default_factory=lambda: _env("LLM_TEMPERATURE", 0.0))

    # --- orchestration ---
    job_retention_days: int = field(
        default_factory=lambda: _env("JOB_RETENTION_DAYS", 7)
    )
    worker_heartbeat_interval_s: float = field(
        default_factory=lambda: _env("WORKER_HEARTBEAT_INTERVAL_S", 15.0)
    )
    worker_heartbeat_ttl_s: float = field(
        default_factory=lambda: _env("WORKER_HEARTBEAT_TTL_S", 60.0)
    )
    task_time_limit_s: float = field(
        default_factory=lambda: _env("TASK_TIME_LIMIT_S", 300.0)
    )
    task_max_retries: int = field(default_factory=lambda: _env("TASK_MAX_RETRIES", 2))
    # optional chain-state persistence (resume after restart); empty = off
    chain_persist_path: str = field(
        default_factory=lambda: _env("CHAIN_PERSIST_PATH", "")
    )
    # job-tracker persistence (job status/results survive an engine
    # restart — the two-process topology's chain-state survival story);
    # empty = off
    tracker_persist_path: str = field(
        default_factory=lambda: _env("TRACKER_PERSIST_PATH", "")
    )
    # reload the last saved index from INDEX_DIR at boot (the compose
    # restart path: docker-compose.yml engine service)
    index_autoload: bool = field(
        default_factory=lambda: _env("INDEX_AUTOLOAD", False, bool)
    )

    # --- ingestion ---
    whisper_model_path: str = field(
        default_factory=lambda: _env("WHISPER_MODEL_PATH", "")
    )
    whisper_timestamps: bool = field(
        default_factory=lambda: _env("WHISPER_TIMESTAMPS", False, bool)
    )
    whisper_beam_size: int = field(
        default_factory=lambda: _env("WHISPER_BEAM_SIZE", 1)
    )
    # tensor-parallel degree for the LLM backend (0/1 = single device;
    # must divide the model's num_kv_heads)
    llm_tensor_parallel: int = field(default_factory=lambda: _env("LLM_TP", 0))
    # 0/16 = bf16 weights; 8 = int8 weight-only quantization (BitsAndBytes
    # parity; halves LLM HBM footprint and decode weight traffic)
    llm_weight_bits: int = field(default_factory=lambda: _env("LLM_WEIGHT_BITS", 0))
    # 0/16 = bf16 KV caches; 8 = per-token int8 KV caches
    llm_kv_bits: int = field(default_factory=lambda: _env("LLM_KV_BITS", 0))
    # >1 runs N llm-queue workers whose generations share decode bursts
    # through the continuous-batching serving engine (serving/engine.py);
    # 1 = the reference's serialized one-at-a-time generation
    llm_concurrency: int = field(default_factory=lambda: _env("LLM_CONCURRENCY", 1))
    # serving-engine knobs (used when llm_concurrency > 1). 0 = auto-size
    # the pool from the mode table (largest context budget + header +
    # generation room, app.py), so every mode's full prompt fits a
    # bucket; prompts beyond the largest bucket fall back to the
    # non-batched whole-loop path rather than truncating.
    llm_serving_max_len: int = field(
        default_factory=lambda: _env("LLM_SERVING_MAX_LEN", 0))
    llm_serving_burst: int = field(
        default_factory=lambda: _env("LLM_SERVING_BURST", 16))
    # speculative bursts in the serving engine (prompt-lookup drafts +
    # (K+1)-wide verify; greedy output identical, copy-heavy RAG answers
    # decode up to K+1 tokens per weight read)
    llm_serving_spec: bool = field(
        default_factory=lambda: _env("LLM_SERVING_SPEC", True, bool))
    # chunked prefill (Sarathi-style): long admissions fill KV in chunks
    # of this many tokens with decode bursts between chunks, bounding the
    # stall a long prompt imposes on in-flight streams; 0 = monolithic
    llm_prefill_chunk: int = field(
        default_factory=lambda: _env("LLM_PREFILL_CHUNK", 0))
    # admission pacing: with live streams, admit ONE request per scheduler
    # step — bounds the decode stall from admission pileup at one prefill
    # for zero extra weight reads (the burst between paced admissions is
    # useful decode work). Idle engines still admit full batches.
    llm_admit_pacing: bool = field(
        default_factory=lambda: _env("LLM_ADMIT_PACING", True, bool))
    # paced admissions per step: a small group shares ONE batched-prefill
    # dispatch (stall ~ one batched prefill, half the admission dispatches)
    llm_admit_pacing_group: int = field(
        default_factory=lambda: _env("LLM_ADMIT_PACING_GROUP", 2))
    # split encoder batches data-parallel over the sharded index's mesh
    encoder_data_parallel: bool = field(
        default_factory=lambda: _env("ENCODER_DP", False, bool)
    )
    ocr_enabled: bool = field(default_factory=lambda: _env("OCR_ENABLED", False, bool))

    # runtime-mutable config (parity with reference /model/update-config)
    def update(self, overrides: dict) -> dict:
        applied = {}
        valid = {f.name for f in fields(self)}
        for key, value in overrides.items():
            if key in valid:
                current = getattr(self, key)
                if current is not None and not isinstance(value, type(current)):
                    try:
                        value = type(current)(value)
                    except (TypeError, ValueError):
                        continue
                setattr(self, key, value)
                applied[key] = value
        return applied

    def to_dict(self) -> dict:
        return asdict(self)

    def save(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.data_dir, "runtime_config.json")
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, ensure_ascii=False, indent=2)
        return path


settings = Settings()
