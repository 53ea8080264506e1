"""Interactive API client REPL.

Counterpart of ``rag_faiss_embedding_tpu/serve/client.py`` (capability
parity with the reference's ``4-api-rag-search.py``): POSTs
``{"text": query, "top_k": k}`` to ``/search`` (``:91-94``), shows the
``similar_documents`` hits (title / score / content preview) and the
``generated_response`` text (``:96-107``), a numeric drill-down detail
view, connection-error handling, ``exit`` to quit. The JAX client runs on
aiohttp and rich; this one on ``urllib.request`` (each request in a worker
thread, ``asyncio.to_thread``) and prints plain text.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import urllib.error
import urllib.request
from typing import List, Optional

from ..core.logging import get_logger
from ..utils.table import format_table, preview

logger = get_logger(__name__)

TIMEOUT_S = 60.0


class APISearch:
    def __init__(self, api_url: str = "http://localhost:8000/search",
                 top_k: int = 3):
        self.api_url = api_url
        self.top_k = top_k

    def print_results(self, results: List[dict], interactive: bool = True) -> None:
        if not results:
            print("server returned no matches")
            return
        rows = [[str(i), doc.get("title") or "(untitled)", f"{doc.get('score', 0):.3f}",
                 preview(doc.get("content", ""))]
                for i, doc in enumerate(results, 1)]
        print(format_table(f"top {len(results)} matches",
                           ["#", "Title", "Score", "Preview"], rows))
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
        print(f"title: {doc.get('title') or '(untitled)'}")
        print(f"url:   {doc.get('url') or '-'}")
        print(f"score: {doc.get('score', 0):.3f}")
        print(doc.get("content") or "(no content)")

    def _post(self, query: str) -> Optional[dict]:
        request = urllib.request.Request(
            self.api_url, data=json.dumps({"text": query, "top_k": self.top_k}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(request, timeout=TIMEOUT_S) as response:
                return json.loads(response.read())
        except urllib.error.HTTPError as e:
            print(f"server replied {e.code} — {e.read().decode(errors='replace')}")
        except (urllib.error.URLError, OSError) as e:
            print(f"cannot reach {self.api_url} ({e}) — is the server up? "
                  "try python -m rag_faiss_embedding_tpu_torch.serve.api")
        return None

    async def query_once(self, session, query: str) -> Optional[dict]:
        """The server's reply to one query, or None (reported). ``session``
        is unused here (the JAX client passes its aiohttp session)."""
        return await asyncio.to_thread(self._post, query)

    async def search_loop(self, interactive: bool = True) -> None:
        print(f"rag-faiss-embedding-tpu API client -> {self.api_url}\n"
              "type a query, or 'exit' when done")
        while True:
            try:
                query = input("\nquery> " if interactive else "")
            except (EOFError, KeyboardInterrupt):
                break
            if query.strip().lower() == "exit":
                break
            if not query.strip():
                continue
            data = await self.query_once(None, query)
            if data is None:
                continue
            self.print_results(data.get("similar_documents", []),
                               interactive=interactive)
            if data.get("generated_response"):
                print("answer: " + data["generated_response"])


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="RAG API search client")
    parser.add_argument("--url", default="http://localhost:8000/search")
    parser.add_argument("--top-k", type=int, default=3)
    args = parser.parse_args(argv)
    searcher = APISearch(api_url=args.url, top_k=args.top_k)
    asyncio.run(searcher.search_loop(interactive=sys.stdin.isatty()))


if __name__ == "__main__":
    main()
