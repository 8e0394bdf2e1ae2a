"""Application assembly: the query path of the RAG system wired together.

Port of ``automative_rag_tpu/app.py``, cut down to what runs in process:
the same objects assembled the same way — dense embedder, flat index,
ColBERT token store, sparse arm, late-interaction reranker, retrieval
engine and the answer generator — behind synchronous ``ingest_text`` and
``query`` calls that run the task bodies ``process_text`` →
``generate_embeddings`` (ingest) and ``retrieve_documents`` →
``llm_inference`` (query) without the job chain. The HTTP API, job-chain
orchestration and the UI are not part of this package yet.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .backend import resolve_device
from .config.settings import Settings, settings as default_settings
from .documents.schema import Document
from .engine.retrieval import RetrievalEngine
from .generation.llm import AnswerGenerator, load_llm
from .index.flat import FlatIndex
from .index.sparse import SparseIndex
from .ingestion.text_processor import TextProcessor
from .models.bge_m3 import DenseEmbedder
from .models.colbert import ColBERTEncoder
from .models.encoder import EncoderConfig
from .models.sparse import SparseEncoder
from .rerank.reranker import LateInteractionReranker
from .rerank.token_store import TokenStore
from .utils.unicode import clean_unicode_escapes


class RAGApplication:
    def __init__(
        self,
        settings: Optional[Settings] = None,
        tiny: bool = False,
        tiny_dim: int = 64,
        device="cuda",
    ):
        self.settings = settings or default_settings
        self.device = resolve_device(device)
        if self.settings.index_kind != "flat":
            raise NotImplementedError(
                f"INDEX_KIND={self.settings.index_kind!r}: only the flat "
                "index is ported")

        if tiny:
            encoder_config = EncoderConfig.tiny(hidden_size=tiny_dim)
            self.settings.embedding_dim = encoder_config.hidden_size
        else:
            encoder_config = EncoderConfig.bge_m3()

        # --- models & engine ---
        self.embedder = DenseEmbedder(
            config=encoder_config,
            weights_path=self.settings.embedding_model_path,
            tokenizer_path=self.settings.embedding_model_path,
            max_length=self.settings.embedding_max_length,
            batch_size=self.settings.embedding_batch_size,
            device=self.device,
        )
        self.colbert = ColBERTEncoder(
            config=encoder_config,
            weights_path=self.settings.colbert_model_path,
            tokenizer_path=self.settings.colbert_model_path,
            max_query_length=self.settings.colbert_max_query_length,
            max_doc_length=self.settings.colbert_max_doc_length,
            batch_size=self.settings.colbert_batch_size,
            device=self.device,
        )
        if self.settings.use_bge_reranker and self.settings.reranker_model_path:
            raise NotImplementedError(
                "RERANKER_MODEL_PATH is set: the cross-encoder second scorer "
                "is not ported yet")
        self.reranker = LateInteractionReranker(self.colbert)
        self.index = self._make_index()
        self.token_store = (
            self._make_token_store() if self.settings.store_token_embeddings else None
        )
        self.sparse_encoder = None
        self.sparse_index = None
        if self.settings.sparse_enabled:
            self.sparse_encoder = SparseEncoder(
                self.embedder,
                top_terms=self.settings.sparse_top_terms,
                query_terms=self.settings.sparse_query_terms,
            )
            self.sparse_index = SparseIndex(
                top_terms=self.settings.sparse_top_terms, device=self.device)
        self.engine = RetrievalEngine(
            self.embedder, self.index, self.reranker,
            token_store=self.token_store,
            sparse_index=self.sparse_index,
            sparse_encoder=self.sparse_encoder,
            sparse_k=self.settings.sparse_k,
            sparse_weight=self.settings.sparse_weight,
            sparse_rerank_weight=self.settings.sparse_rerank_weight,
            cache_size=self.settings.retrieval_cache_size,
        )
        self.generator = AnswerGenerator(load_llm(self.settings.llm_model_path))
        self._lock = threading.RLock()

    def _make_index(self) -> FlatIndex:
        return FlatIndex(dim=self.embedder.dim,
                         device_dtype=self.settings.index_dtype,
                         device=self.device)

    def _make_token_store(self) -> TokenStore:
        if self.settings.token_store_sharded:
            raise NotImplementedError("TOKEN_STORE_SHARDED is not ported")
        return TokenStore(
            dim=self.colbert.dim,
            max_doc_length=self.colbert.max_doc_length,
            device_dtype=(
                "bfloat16" if self.settings.index_dtype in ("int8", "int4")
                else self.settings.index_dtype
            ),
            device_budget_bytes=self.settings.token_store_device_budget_mb * 1024**2,
            quantize=self.settings.token_store_quantize,
            device=self.device,
        )

    # ------------------------------------------------------------ tasks
    def process_text(self, content: str, metadata: Optional[Dict[str, Any]] = None
                     ) -> List[Document]:
        """Chunk + metadata-inject one text (the ``process_text`` task)."""
        return TextProcessor().process({"content": content, **(metadata or {})})

    def generate_embeddings(self, docs: List[Document]) -> Dict[str, Any]:
        """Index chunk documents in every store (``generate_embeddings``)."""
        if not docs:
            return {"document_count": 0, "document_ids": []}
        with self._lock:  # index row + token-store row + sparse row pair up
            ids = self.engine.add_documents(docs)
        return {"document_count": len(ids), "document_ids": ids}

    def retrieve_documents(self, query: str, mode: str = "facts",
                           metadata_filter: Optional[Dict[str, Any]] = None
                           ) -> Dict[str, Any]:
        """The ``retrieve_documents`` task body."""
        payload = clean_unicode_escapes(
            {"query": query, "mode": mode, "metadata_filter": metadata_filter})
        ranked = self.engine.retrieve(
            payload["query"], mode=payload["mode"],
            metadata_filter=payload["metadata_filter"])
        return {
            "documents": [
                {**doc.to_dict(), "relevance_score": score} for doc, score in ranked
            ],
            "retrieval_timings": self.engine.last_timings,
        }

    def llm_inference(self, query: str, documents: List[Dict[str, Any]],
                      mode: str = "facts") -> Dict[str, Any]:
        """The ``llm_inference`` task body."""
        docs = [
            (Document.from_dict(d), float(d.get("relevance_score", 0.0)))
            for d in documents
        ]
        return self.generator.answer(query, docs, mode=mode)

    # ------------------------------------------------------------ public
    def ingest_text(self, content: str, metadata: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        """Chunk, embed and index one text; → {document_count, document_ids}."""
        return self.generate_embeddings(self.process_text(content, metadata))

    def query(self, query: str, mode: str = "facts",
              metadata_filter: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Retrieve and answer; → the answer dict plus ``documents`` and
        ``retrieval_timings``."""
        retrieved = self.retrieve_documents(query, mode, metadata_filter)
        result = self.llm_inference(query, retrieved["documents"], mode)
        result["documents"] = retrieved["documents"]
        result["retrieval_timings"] = retrieved["retrieval_timings"]
        return result
