"""automative_rag_tpu_torch — the PyTorch/CUDA port of automative_rag_tpu.

The query path of the bilingual automotive RAG application on one NVIDIA
H100: ingest text → dense search with metadata filters → the sparse
lexical arm → ColBERT MaxSim rerank from the token store → cited extractive
answer. Plain tensor code is PyTorch; the MaxSim rerank (K1) and the sparse
scan (K3/K3b) run through CUDA C++ kernels written for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises rather than carrying on on the CPU. The package imports
nothing of ``automative_rag_tpu`` and nothing of JAX: the JAX-free modules
it needs are its own copies.
"""

__version__ = "0.1.0"
