"""Document validation and pluggable summarization.

Counterpart of ``rag_faiss_embedding_tpu/ingest/validator.py`` (the
reference ``DocumentValidator``, ``document_validator.py:26-331``): clean /
normalize url + title + content, reject docs with missing fields or < 10
content words, compute metadata (word_count, original / cleaned length,
summary, summary_length), batch validation with a summary table, and a JSON
in -> JSON out CLI (reads ``search-index.json``, writes
``validated-index.json``). The JAX module's code, but for two changes:
``display_summary`` prints plain text (no ``rich``), and the "embed" method
takes this package's ``EmbeddingPipeline`` (its ``generate_embeddings``
returns numpy, as JAX's does).

Summarization methods (reference offers spacy/transformers/textrank/basic):
- "basic"      first 3 sentences (reference ``:185-195``)
- "textrank"   PageRank over a TF-cosine sentence graph via networkx
               (reference ``summarize_textrank``, ``:153-183``)
- "embed"      rank sentences by embedding-space centrality with the
               encoder (replaces "spacy")
- "transformers" HF abstractive summarization pipeline, gated on a local
               checkpoint cache (reference ``:40-47``)
Every method falls back to "basic" if its dependency is unavailable, same
policy as the reference.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core.logging import get_logger
from ..utils.text import cosine_sim, sentence_split, tf_vector

logger = get_logger(__name__)

_MIN_CONTENT_WORDS = 10


class DocumentValidator:
    def __init__(
        self,
        default_input: str | Path = "data/search-index.json",
        default_output: str | Path = "data/validated-index.json",
        summarization_method: str = "basic",
        max_summary_sentences: int = 3,
        embedder=None,
    ):
        self.required_fields = ["url", "title", "content"]
        self.default_input = Path(default_input)
        self.default_output = Path(default_output)
        self.max_summary_sentences = max_summary_sentences
        self.summarization_method = summarization_method
        self._embedder = embedder
        self._hf_summarizer = None

        if summarization_method == "transformers":
            try:
                from transformers import pipeline

                self._hf_summarizer = pipeline(
                    "summarization",
                    model="facebook/bart-large-cnn",
                    model_kwargs={"local_files_only": True},
                )
            except Exception as e:
                logger.warning(
                    "transformers summarizer unavailable (%s); using basic", e
                )
                self.summarization_method = "basic"
        elif summarization_method == "embed" and embedder is None:
            logger.warning("no embedder provided for 'embed'; using basic")
            self.summarization_method = "basic"
        elif summarization_method == "textrank":
            try:
                import networkx  # noqa: F401
            except ImportError:
                logger.warning("networkx unavailable; using basic")
                self.summarization_method = "basic"
        logger.info(
            "initialized DocumentValidator with %s summarization",
            self.summarization_method,
        )

    # ------------------------------------------------------------ cleaning
    @staticmethod
    def clean_url(url: str) -> str:
        if not url:
            return ""
        url = url.strip()
        if not url.startswith(("http://", "https://")):
            url = f"https://{url}"
        return url

    @staticmethod
    def clean_title(title: str) -> str:
        return " ".join(title.split()).strip() if title else ""

    @staticmethod
    def clean_content(content: str) -> str:
        if not content:
            return ""
        content = re.sub(r"[^\w\s.,]", " ", content)
        return " ".join(content.split()).strip().lower()

    # --------------------------------------------------------- summarizers
    def summarize_basic(self, text: str) -> str:
        return " ".join(sentence_split(text)[: self.max_summary_sentences])

    def summarize_textrank(self, text: str) -> str:
        import networkx as nx

        sentences = sentence_split(text)
        if len(sentences) <= self.max_summary_sentences:
            return " ".join(sentences)
        vecs = [tf_vector(s) for s in sentences]
        graph = nx.Graph()
        graph.add_nodes_from(range(len(sentences)))
        for i in range(len(sentences)):
            for j in range(i + 1, len(sentences)):
                w = cosine_sim(vecs[i], vecs[j])
                if w > 0:
                    graph.add_edge(i, j, weight=w)
        try:
            scores = nx.pagerank(graph, weight="weight")
        except Exception:
            return self.summarize_basic(text)
        ranked = sorted(scores, key=scores.get, reverse=True)
        picked = sorted(ranked[: self.max_summary_sentences])
        return " ".join(sentences[i] for i in picked)

    def summarize_embed(self, text: str) -> str:
        """Embedding-space centrality: pick sentences whose encoder embedding
        is closest to the mean document embedding (batched on the encoder's
        device)."""
        import numpy as np

        sentences = sentence_split(text)
        if len(sentences) <= self.max_summary_sentences:
            return " ".join(sentences)
        emb = self._embedder.generate_embeddings(sentences)
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
        centroid = emb.mean(axis=0)
        scores = emb @ centroid
        picked = sorted(np.argsort(-scores)[: self.max_summary_sentences].tolist())
        return " ".join(sentences[i] for i in picked)

    def summarize_transformers(self, text: str) -> str:
        out = self._hf_summarizer(
            text[:3000], max_length=130, min_length=20, do_sample=False
        )
        return out[0]["summary_text"]

    def summarize_text(self, text: str) -> str:
        method = self.summarization_method
        try:
            if method == "textrank":
                return self.summarize_textrank(text)
            if method == "embed":
                return self.summarize_embed(text)
            if method == "transformers":
                return self.summarize_transformers(text)
        except Exception as e:
            logger.warning("summarizer %s failed (%s); using basic", method, e)
        return self.summarize_basic(text)

    # ----------------------------------------------------------- validation
    def validate_document(self, doc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Reference ``validate_document`` semantics (``:89-133``)."""
        try:
            if not doc:
                logger.warning("empty document received")
                return None
            missing = [f for f in self.required_fields if f not in doc]
            if missing:
                logger.warning("document missing required fields: %s", missing)
                return None
            url = self.clean_url(doc["url"])
            title = self.clean_title(doc["title"])
            content = self.clean_content(doc["content"])
            if not url or not re.match(r"^https?://", url):
                logger.warning("invalid URL in document: %s", doc.get("title"))
                return None
            if len(content.split()) < _MIN_CONTENT_WORDS:
                logger.warning("content too short: %s", doc.get("title"))
                return None
            summary = self.summarize_text(content)
            return {
                "url": url,
                "title": title or "Untitled",
                "content": content,
                "metadata": {
                    "word_count": len(content.split()),
                    "original_length": len(doc.get("content", "")),
                    "cleaned_length": len(content),
                    "summary": summary,
                    "summary_length": len(summary.split()),
                },
            }
        except Exception as e:
            logger.error("error validating document: %s", e)
            return None

    def batch_validate_documents(
        self, documents: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Reference ``batch_validate_documents`` (``:205-224``)."""
        validated = []
        for doc in documents:
            v = self.validate_document(doc)
            if v:
                validated.append(v)
        logger.info("validated %d/%d documents", len(validated), len(documents))
        return validated

    # ---------------------------------------------------------------- cli
    def summary_stats(self, docs: List[Dict[str, Any]]) -> List[tuple]:
        """Corpus statistics rows (reference ``display_summary``,
        ``document_validator.py:238-253``): averages, reduction percentage,
        extremes, and the active summarization method."""
        n = len(docs)
        if n == 0:  # public API: an empty validation run gets an empty table
            return [
                ("Total Documents", "0"),
                ("Summarization Method", self.summarization_method),
            ]
        wc = [d["metadata"]["word_count"] for d in docs]
        avg_red = sum(
            (d["metadata"]["original_length"] - d["metadata"]["cleaned_length"])
            / max(d["metadata"]["original_length"], 1) * 100
            for d in docs
        ) / n
        avg_sum = sum(d["metadata"]["summary_length"] for d in docs) / n
        return [
            ("Total Documents", str(n)),
            ("Unique URLs", str(len({d["url"] for d in docs}))),
            ("Average Word Count", f"{sum(wc) / n:.1f}"),
            ("Average Content Reduction", f"{avg_red:.1f}%"),
            ("Shortest Document", str(min(wc))),
            ("Longest Document", str(max(wc))),
            ("Average Summary Length", f"{avg_sum:.1f} words"),
            ("Summarization Method", self.summarization_method),
        ]

    def display_summary(self, docs: List[Dict[str, Any]]) -> None:
        """Stats table + sample preview, as plain text (reference
        ``display_summary``, ``document_validator.py:226-270``)."""
        if not docs:
            print("No valid documents to display")
            return
        rows = self.summary_stats(docs)
        width = max(len(metric) for metric, _ in rows)
        print("\nDocument Validation Summary")
        for metric, value in rows:
            print(f"  {metric:>{width}}  {value}")
        doc = docs[0]
        print("\nSample Document Preview:")
        print(f"  Title: {doc['title']}")
        print(f"  URL: {doc['url']}")
        print(f"  Content Preview: {' '.join(doc['content'].split()[:20])}...")
        print(f"  Summary: {doc['metadata']['summary']}")
        print(f"  Word Count: {doc['metadata']['word_count']}")

    def run(
        self,
        input_path: Optional[str | Path] = None,
        output_path: Optional[str | Path] = None,
        show_summary: bool = True,
    ) -> List[Dict[str, Any]]:
        inp = Path(input_path or self.default_input)
        out = Path(output_path or self.default_output)
        documents = json.loads(inp.read_text())
        validated = self.batch_validate_documents(documents)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(validated, indent=2, ensure_ascii=False))
        logger.info("wrote %d validated documents to %s", len(validated), out)
        if show_summary:
            self.display_summary(validated)
        return validated


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Validate and summarize documents")
    p.add_argument("--input", default="data/search-index.json")
    p.add_argument("--output", default="data/validated-index.json")
    p.add_argument(
        "--method",
        default="basic",
        choices=["basic", "textrank", "embed", "transformers"],
    )
    p.add_argument("--device", default=None,
                   help="the encoder's device for 'embed' (default: the card)")
    args = p.parse_args(argv)
    embedder = None
    if args.method == "embed":
        from ..models import EmbeddingPipeline

        embedder = EmbeddingPipeline(device=args.device)
    v = DocumentValidator(
        default_input=args.input,
        default_output=args.output,
        summarization_method=args.method,
        embedder=embedder,
    )
    v.run()


if __name__ == "__main__":
    main()
