"""Interactive CLI search REPL.

Counterpart of ``rag_faiss_embedding_tpu/cli/search.py`` (capability
parity with ``2-cli-rag-search.py``): a results table (doc number / title /
similarity / content preview), similarity shown as ``1/(1+distance)``
(``2-cli-rag-search.py:48``), a numeric drill-down into a per-document
detail view, and ``exit`` to quit. Plain text (the JAX CLI draws with
``rich``). Also usable non-interactively (queries on stdin or argv).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..core.config import Config
from ..core.logging import get_logger
from ..rag.manager import RAGManager
from ..utils.table import format_table, preview

logger = get_logger(__name__)


class CLISearch:
    def __init__(self, manager: Optional[RAGManager] = None,
                 config: Optional[Config] = None, device=None):
        self.manager = manager or RAGManager(config=config, device=device)
        self.manager.load_indices()

    @staticmethod
    def similarity(doc: dict) -> float:
        return 1.0 / (1.0 + doc.get("distance", 0.0))

    def print_results(self, results: List[dict], interactive: bool = True) -> None:
        if not results:
            print("no matches — try different terms")
            return
        rows = [[str(i), doc.get("title") or "(untitled)",
                 f"{self.similarity(doc):.3f}", preview(doc.get("content", ""))]
                for i, doc in enumerate(results, 1)]
        print(format_table(f"top {len(results)} matches",
                           ["#", "Title", "Similarity", "Preview"], rows))
        if not interactive:
            return
        print(f"open a result? type 1-{len(results)}, blank to skip")
        try:
            choice = input("open> ").strip()
        except EOFError:
            return
        if choice.isdigit() and 1 <= int(choice) <= len(results):
            self.show_detailed_view(results[int(choice) - 1])

    def show_detailed_view(self, doc: dict) -> None:
        print(f"title:      {doc.get('title') or '(untitled)'}")
        print(f"url:        {doc.get('url') or '-'}")
        print(f"similarity: {self.similarity(doc):.3f}")
        print(doc.get("content") or "(no content)")

    def search(self, query: str, k: Optional[int] = None) -> List[dict]:
        try:
            return self.manager.search_similar_documents(query, k)
        except Exception as e:
            logger.error("search error: %s", e)
            return []

    def search_loop(self, interactive: bool = True) -> None:
        print("rag-faiss-embedding-tpu search — type a query, or 'exit' when done")
        while True:
            try:
                query = input("\nquery> " if interactive else "")
            except (EOFError, KeyboardInterrupt):
                break
            if query.strip().lower() == "exit":
                break
            if not query.strip():
                continue
            self.print_results(self.search(query), interactive=interactive)

    def cleanup(self) -> None:
        self.manager.cleanup()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Interactive RAG search")
    parser.add_argument("--base-dir", default=".", help="framework base dir")
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' only when asked)")
    parser.add_argument("query", nargs="*", help="one-shot query (skips REPL)")
    args = parser.parse_args(argv)
    cfg = Config.from_env(base_dir=args.base_dir)
    searcher = CLISearch(config=cfg, device=args.device)
    try:
        if args.query:
            results = searcher.search(" ".join(args.query), args.top_k)
            searcher.print_results(results, interactive=False)
        else:
            searcher.search_loop(interactive=sys.stdin.isatty())
    finally:
        searcher.cleanup()


if __name__ == "__main__":
    main()
