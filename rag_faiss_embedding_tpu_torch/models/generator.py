"""Answer generation for the RAG stage.

A copy of ``rag_faiss_embedding_tpu/models/generator.py`` that imports no
JAX (importing that module runs ``models/__init__``, which loads the Flax
encoder).

The reference uses an HF ``text2text-generation`` pipeline with FLAN-T5-base,
max_length=200 (``query.py:15-17,95``). This image has no model cache and no
egress, so generation is pluggable:

- "hf": the reference's FLAN-T5 pipeline, used when a local checkpoint cache
  exists (exact capability parity);
- "extractive": dependency-free fallback — selects the retrieved-context
  sentences most relevant to the query by TF cosine and stitches them into a
  short answer. Keeps the RAG loop fully functional offline.

The prompt template and the 400-token context budget split across documents
mirror ``query.py:71-92``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from rag_faiss_embedding_tpu.core.logging import get_logger
from rag_faiss_embedding_tpu.utils.text import cosine_sim, sentence_split, tf_vector

logger = get_logger(__name__)


class AnswerGenerator:
    def __init__(
        self,
        model_name: str = "google/flan-t5-base",
        backend: str = "auto",  # "auto" | "hf" | "extractive"
        max_length: int = 200,
        min_length: int = 20,
    ):
        self.model_name = model_name
        self.max_length = max_length
        self.min_length = min_length
        self._pipe = None
        if backend in ("auto", "hf"):
            try:
                from transformers import pipeline

                self._pipe = pipeline(
                    "text2text-generation",
                    model=model_name,
                    max_length=max_length,
                    model_kwargs={"local_files_only": True},
                )
                self.backend = "hf"
                logger.info("using HF generator %s", model_name)
            except Exception as e:
                if backend == "hf":
                    raise
                logger.info(
                    "no local generator checkpoint (%s); using extractive backend", e
                )
                self.backend = "extractive"
        else:
            self.backend = "extractive"

    def build_prompt(self, query: str, context: str) -> str:
        """Reference prompt template (``query.py:88-92``)."""
        return (
            f"Based on the following documents, provide a brief answer to "
            f"this question: {query}\n\n"
            f"Context:\n{context}\n\n"
            f"Answer:"
        )

    def generate(self, query: str, context: str) -> str:
        if self.backend == "hf":
            out = self._pipe(
                self.build_prompt(query, context),
                max_length=self.max_length,
                min_length=self.min_length,
            )
            return out[0]["generated_text"].strip()
        return self._extractive(query, context)

    def _extractive(self, query: str, context: str) -> str:
        qv = tf_vector(query)
        # Context lines alternate "Document N (...):" headers and content;
        # strip headers, then sentence-split the content lines.
        sentences = []
        for line in context.splitlines():
            line = line.strip()
            if not line or line.startswith("Document "):
                continue
            sentences.extend(sentence_split(line) or [line])
        scored = []
        for sent in sentences:
            if len(sent.split()) < 3:
                continue
            scored.append((cosine_sim(qv, tf_vector(sent)), sent))
        scored.sort(key=lambda x: -x[0])
        picked: List[str] = []
        budget = self.max_length  # ~words, approximating the token budget
        for score, sent in scored:
            if score <= 0:
                break
            words = len(sent.split())
            if words > budget:
                continue
            picked.append(sent)
            budget -= words
            if len(picked) >= 3:
                break
        if not picked:
            return "No relevant information found in the retrieved documents."
        return " ".join(picked)
