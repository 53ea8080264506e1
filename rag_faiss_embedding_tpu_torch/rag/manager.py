"""End-to-end RAG pipeline manager.

Counterpart of ``rag_faiss_embedding_tpu/rag/manager.py`` (the reference's
``RAGDatabaseManager``, ``rag_datastore_manager.py:134-265``), building this
package's ``VectorStore`` and ``EmbeddingPipeline`` on ``device``:

- ``initialize_database()``: documents -> SQLite -> embed -> index ->
  persist the index + id mapping;
- ``add_documents()``: streaming adds; a re-added url replaces its document
  and tombstones the old vector;
- ``load_indices()``, ``search_similar_documents()``, ``delete_documents()``,
  ``reset()``.

``index_kind`` "flat", "ivf" (IVF-Flat, or IVF-PQ with ``ivf_pq_m > 0``) and
"pq" build their index on ``device``, as the JAX manager builds them. Data
files (``documents.db``, ``index.tpu`` + ``.mapping``, ``vocab.txt``,
``encoder_params.npz``) are the JAX package's formats.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..core.config import Config
from ..core.logging import get_logger
from ..store.database import Database

from .. import default_device
from ..index.ivf import IVFFlatIndex
from ..index.pq import PQIndex
from ..index.vector_store import VectorStore
from ..models.encoder import EmbeddingPipeline

logger = get_logger(__name__)


class RAGManager:
    def __init__(
        self,
        config: Optional[Config] = None,
        embedder: Optional[EmbeddingPipeline] = None,
        index_kind: Optional[str] = None,
        device: Optional[torch.device | str] = None,
    ):
        self.config = config or Config.from_env()
        self.index_kind = index_kind or self.config.index_kind
        self.device = torch.device(device) if device is not None else default_device()
        self.config.setup_directories()
        self.db = Database(self.config.db_path)
        self.embedder = embedder or EmbeddingPipeline(
            model_name=self.config.model_name,
            pooling=self.config.pooling,
            max_seq_length=self.config.max_seq_length,
            vocab_path=self.config.data_dir / "vocab.txt",
            params_path=self.config.data_dir / "encoder_params.npz",
            normalize=self.config.index_metric == "IP",
            device=self.device,
        )
        # the index dimension is always the encoder's output width
        dim = self.embedder.cfg.hidden_size
        index = None
        if self.index_kind == "ivf":
            index = IVFFlatIndex(
                dim,
                nlist=self.config.ivf_nlist,
                nprobe=self.config.ivf_nprobe,
                metric=self.config.index_metric,
                dtype=self.config.index_dtype,
                balance=self.config.ivf_balance,
                pq_m=self.config.ivf_pq_m or None,
                device=self.device,
            )
        elif self.index_kind == "pq":
            index = PQIndex(dim, metric=self.config.index_metric, device=self.device)
        self.vector_store = VectorStore(
            dimension=dim,
            metric=self.config.index_metric,
            index_path=self.config.index_path,
            dtype=self.config.index_dtype,
            selector=self.config.search_selector,
            index=index,
            device=self.device,
        )

    # ------------------------------------------------------------- loading
    def load_documents(self, path: Optional[Path] = None) -> List[Dict]:
        """Load documents.json (``rag_datastore_manager.py:141-154``)."""
        path = Path(path or self.config.documents_json)
        if not path.exists():
            logger.error("documents file not found: %s", path)
            return []
        documents = json.loads(path.read_text())
        logger.info("loaded %d documents from %s", len(documents), path)
        return documents

    def _embed(self, documents: List[Dict]):
        contents = [doc["content"] for doc in documents]
        if self.embedder.tokenizer is None:
            self.embedder.fit_tokenizer(contents)
        return self.embedder.generate_embeddings(
            contents, batch_size=self.config.batch_size)

    def initialize_database(self, documents: Optional[List[Dict]] = None) -> int:
        """Ingest documents end to end (``rag_datastore_manager.py:156-180``)."""
        documents = documents if documents is not None else self.load_documents()
        if not documents:
            logger.warning("no documents found to process")
            return 0
        ids = self.db.insert_documents(documents)
        self.vector_store.add_vectors(self._embed(documents), ids)
        self.vector_store.save_index()
        logger.info("initialized database with %d documents", len(ids))
        return len(ids)

    def add_documents(self, documents: List[Dict]) -> int:
        """Streaming adds: insert + embed + append to the live index. A
        re-added url REPLACES its document, and the superseded vector is
        tombstoned."""
        if not documents:
            return 0
        prior_ids = [
            pid for doc in documents
            if (pid := self.db.get_document_id_by_url(doc["url"])) is not None
        ]
        if prior_ids:
            self.vector_store.remove_doc_ids(prior_ids)
        ids = self.db.insert_documents(documents)
        self.vector_store.add_vectors(self._embed(documents), ids)
        return len(ids)

    def load_indices(self) -> None:
        """Load persisted index or lazily build (``:202-209``)."""
        if Path(self.config.index_path).exists():
            self.vector_store.load_index()
            logger.info("loaded existing index")
        else:
            logger.warning("no existing index found; building")
            self.initialize_database()

    # -------------------------------------------------------------- search
    def search_similar_documents(
        self, query: str, k: Optional[int] = None,
        where: Optional[Dict] = None,
    ) -> List[Dict]:
        """Embed -> scan -> fetch with raw distance (``:211-238``).
        ``where``: optional metadata predicate (``Database.select_ids``
        keys) applied inside the scan. As in the JAX manager, a failure is
        logged and gives an empty list."""
        k = k or self.config.top_k
        try:
            allowed = self.db.select_ids(where) if where is not None else None
            if allowed is not None and not allowed:
                return []
            emb = self.embedder.embed_query(query)
            distances, doc_ids = self.vector_store.search(
                emb, k, allowed_doc_ids=allowed)
            docs = self.db.get_documents_by_ids(doc_ids)
            results = []
            for doc, dist in zip(docs, distances):
                if doc is not None:
                    doc["distance"] = float(dist)
                    results.append(doc)
            return results
        except Exception:
            logger.exception("error searching documents")
            return []

    # ------------------------------------------------------------ deletion
    def delete_documents(
        self,
        doc_ids: Optional[List[int]] = None,
        urls: Optional[List[str]] = None,
        persist: bool = False,
    ) -> int:
        """Delete documents by id and/or url from BOTH stores: vectors are
        tombstoned in place, SQLite rows dropped; ``persist=True`` re-saves
        the index. Returns the number of documents deleted."""
        ids = [int(i) for i in (doc_ids or [])]
        for url in urls or []:
            found = self.db.get_document_id_by_url(url)
            if found is not None:
                ids.append(found)
            else:
                logger.warning("delete: no document with url %s", url)
        ids = sorted(set(ids))
        if not ids:
            return 0
        self.vector_store.remove_doc_ids(ids)
        n = self.db.delete_documents(ids)
        if persist:
            self.vector_store.save_index()
        logger.info("deleted %d documents", n)
        return n

    # ------------------------------------------------------------- cleanup
    def reset(self) -> None:
        """Delete db + index artifacts (reference ``main()``, ``:244-253``)."""
        self.db.close()
        for p in (
            Path(self.config.db_path),
            Path(self.config.index_path),
            Path(str(self.config.index_path) + ".mapping"),
        ):
            if p.exists():
                p.unlink()
                logger.info("removed %s", p)
        self.db = Database(self.config.db_path)
        self.vector_store.reset()

    def cleanup(self) -> None:
        self.db.close()
