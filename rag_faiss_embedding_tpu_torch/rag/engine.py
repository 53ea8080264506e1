"""Query / RAG engine: retrieve -> score -> generate.

A copy of ``rag_faiss_embedding_tpu/rag/engine.py`` over this package's
``VectorStore``, ``EmbeddingPipeline`` and ``AnswerGenerator`` (importing
the JAX module runs ``rag/__init__``, which loads JAX). Its behaviour is the
JAX engine's, except that ``search_batch`` does not pad its queries to a
power-of-two count and a ``top_k`` the index cannot serve raises.

Capability parity with the reference ``QueryEngine`` (``query.py:10-102``)
and ``RAGDatabaseManager.search_similar_documents``
(``rag_datastore_manager.py:211-238``):

- ``search(query, top_k)``: embed the query, exact/IVF top-k over the vector
  store, fetch documents from SQLite by mapped id, attach
  ``score = 1/(1+distance)`` (``query.py:42``) and raw ``distance``.
- ``generate_response(query, docs)``: pack a context under a 400-token budget
  split evenly across documents (``query.py:71-79``), prompt-template it and
  run the generator (``query.py:88-95``).

Deliberate fixes of reference quirks (SURVEY.md §7): no ``idx+1`` re-mapping
of already-mapped ids (``query.py:40`` double-maps and returns the wrong
documents whenever ids aren't accidentally aligned); document fetches are
batched into one SQLite query instead of per-hit point lookups
(``rag_datastore_manager.py:229``); the id mapping is resident, not
re-unpickled per query (``:221-223``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.logging import get_logger
from ..store.database import Database

from ..index.vector_store import VectorStore
from ..models.encoder import EmbeddingPipeline
from ..models.generator import AnswerGenerator

logger = get_logger(__name__)


class QueryEngine:
    def __init__(
        self,
        db: Database,
        vector_store: VectorStore,
        embedder: EmbeddingPipeline,
        generator: Optional[AnswerGenerator] = None,
        context_token_budget: int = 400,
    ):
        self.db = db
        self.vector_store = vector_store
        self.embedder = embedder
        self.generator = generator or AnswerGenerator()
        self.context_token_budget = context_token_budget

    # -------------------------------------------------------------- search
    def _resolve_where(self, where: Optional[Dict]) -> Optional[List[int]]:
        """Metadata predicate -> allowed doc ids (pre-filtering); None
        means unfiltered. An empty allowlist short-circuits to no hits."""
        if where is None:
            return None
        return self.db.select_ids(where)

    def search(self, query: str, top_k: int = 5,
               where: Optional[Dict] = None) -> List[Dict]:
        """Embed -> top-k -> fetch -> score (``query.py:21-55``).

        ``where``: optional metadata predicate (``Database.select_ids``
        keys, e.g. ``{"url_prefix": "https://docs."}``) — resolved to a
        doc-id allowlist and applied INSIDE the scan (filtered search).
        An invalid predicate raises ``ValueError`` (caller input error);
        runtime search failures degrade to an empty result."""
        allowed = self._resolve_where(where)  # ValueError propagates
        try:
            emb = self.embedder.embed_query(query)
            return self.search_by_vector(emb, top_k, allowed_doc_ids=allowed)
        except Exception:
            logger.exception("search error")
            return []

    def search_by_vector(self, query_vector, top_k: int = 5,
                         allowed_doc_ids=None) -> List[Dict]:
        if allowed_doc_ids is not None and not len(allowed_doc_ids):
            return []
        distances, doc_ids = self.vector_store.search(
            query_vector, top_k, allowed_doc_ids=allowed_doc_ids
        )
        docs = self.db.get_documents_by_ids(doc_ids)
        results: List[Dict] = []
        for doc, doc_id, dist in zip(docs, doc_ids, distances):
            if doc is None:
                logger.warning("hit doc id %s missing from store", doc_id)
                continue
            dist = float(dist)
            doc["distance"] = dist
            if self.vector_store.metric == "IP":
                doc["score"] = dist  # higher inner product = better
            else:
                doc["score"] = 1.0 / (1.0 + dist)  # query.py:42 convention
            results.append(doc)
        logger.debug("query returned %d documents", len(results))
        return results

    def search_batch(self, queries: List[str], top_k: int = 5,
                     where: Optional[Dict] = None) -> List[List[Dict]]:
        """Batched variant for the API server: one encoder pass + one scan
        for the whole batch (no reference analog — it loops one by one).

        Unlike the JAX engine, the query rows are not padded to a
        power-of-two bucket: that caps JIT compiles there, and here the
        encoder and the scan kernel take any row count without one."""
        allowed = self._resolve_where(where)
        if allowed is not None and not len(allowed):
            return [[] for _ in queries]
        embs = self.embedder.generate_embeddings(queries)
        dists, ids = self.vector_store.search(
            embs, top_k, allowed_doc_ids=allowed
        )
        out = []
        for row_d, row_ids in zip(dists, ids):
            docs = self.db.get_documents_by_ids(row_ids)
            results = []
            for doc, dist in zip(docs, row_d):
                if doc is None:
                    continue
                dist = float(dist)
                doc["distance"] = dist
                doc["score"] = (
                    dist if self.vector_store.metric == "IP" else 1.0 / (1.0 + dist)
                )
                results.append(doc)
            out.append(results)
        return out

    # ------------------------------------------------------------ generate
    def truncate_content(self, content: str, max_tokens: int) -> str:
        """Token-budget truncation (``query.py:57-60``), using the framework
        tokenizer's wordpiece count when available, else whitespace words."""
        tok = self.embedder.tokenizer
        if tok is None:
            words = content.split()
            return " ".join(words[:max_tokens])
        ids = tok.encode(content, max_length=max_tokens + 2)
        return tok.decode(ids)

    def generate_response(self, query: str, documents: List[Dict]) -> str:
        """Context packing + generation (``query.py:62-102``)."""
        if not documents:
            return "No relevant documents found to answer your query."
        try:
            max_per_doc = max(1, self.context_token_budget // len(documents))
            parts = []
            for i, doc in enumerate(documents, 1):
                truncated = self.truncate_content(
                    doc.get("content", ""), max_per_doc
                )
                parts.append(
                    f"Document {i} (Score: {doc.get('score', 0.0):.3f}, "
                    f"Title: {doc.get('title', 'Unknown')}):\n{truncated}\n"
                )
            context = "\n".join(parts)
            return self.generator.generate(query, context)
        except Exception:
            logger.exception("response generation error")
            return "I apologize, but I encountered an error generating a response."

    def close(self) -> None:
        self.db.close()
