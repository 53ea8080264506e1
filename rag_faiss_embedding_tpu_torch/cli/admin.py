"""Menu-driven admin tool.

Counterpart of ``rag_faiss_embedding_tpu/cli/admin.py``, building its
``RAGManager`` on ``--device``. Capability parity with ``datastore_manager.py:26-236`` — the reference's
8-option maintenance menu (initialize db / load documents / save indices /
load indices / verify system / document count / test search / exit), plus
a 9th option the reference cannot offer: per-document deletion (it can
only drop the whole database). The
reference version is broken legacy code calling MongoDB-era methods that no
longer exist (``datastore_manager.py:227-236`` calls ``collection.drop`` etc.
on the SQLite Database — SURVEY.md §2 row 12); this one actually works
against the framework stack, including the ``verify_system`` self-test
(embed a stored doc, search for itself, expect a hit —
``datastore_manager.py:135-175``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..core.config import Config
from ..core.logging import get_logger
from ..rag.manager import RAGManager

logger = get_logger(__name__)

MENU = """
RAG Datastore Admin
  1) Initialize database (reset + ingest documents.json)
  2) Load documents from documents.json (incremental)
  3) Save indices
  4) Load indices
  5) Verify system (self-similarity smoke test)
  6) Show document count
  7) Test similarity search
  8) Delete document (by id or url)
  9) Exit
"""


class AdminTool:
    def __init__(self, config: Optional[Config] = None,
                 manager: Optional[RAGManager] = None, device=None):
        self.manager = manager or RAGManager(config=config, device=device)

    def initialize(self) -> int:
        self.manager.reset()
        return self.manager.initialize_database()

    def load_documents(self) -> int:
        docs = self.manager.load_documents()
        return self.manager.add_documents(docs)

    def save_indices(self) -> None:
        self.manager.vector_store.save_index()

    def load_indices(self) -> None:
        self.manager.load_indices()

    def verify_system(self) -> bool:
        """Embed a stored document and check it retrieves itself
        (``datastore_manager.py:135-175``)."""
        docs = self.manager.db.fetch_all_documents()
        if not docs:
            print("VERIFY: no documents in store")
            return False
        sample = docs[0]
        results = self.manager.search_similar_documents(
            sample["content"][:1000], k=3
        )
        ok = bool(results) and any(r["id"] == sample["id"] for r in results)
        print(f"VERIFY: {'OK' if ok else 'FAILED'} — "
              f"sample doc {sample['id']} -> {[r['id'] for r in results]}")
        return ok

    def document_count(self) -> int:
        n = self.manager.db.get_document_count()
        print(f"documents: {n}; indexed vectors: {self.manager.vector_store.ntotal}")
        return n

    def delete_document(self, ident: str) -> int:
        """Delete one document by numeric id or by url (tombstones the
        vector, drops the SQLite row, persists the index)."""
        ident = ident.strip()
        if ident.isdigit():
            n = self.manager.delete_documents(doc_ids=[int(ident)],
                                              persist=True)
        else:
            n = self.manager.delete_documents(urls=[ident], persist=True)
        print(f"deleted {n} document(s)")
        return n

    def test_search(self, query: str) -> None:
        results = self.manager.search_similar_documents(query)
        for i, doc in enumerate(results, 1):
            print(f"{i}. [{doc['id']}] {doc['title']} "
                  f"(distance {doc['distance']:.4f})")

    def run_menu(self) -> None:
        while True:
            print(MENU)
            try:
                choice = input("Select option: ").strip()
            except EOFError:
                break
            if choice == "1":
                print(f"initialized {self.initialize()} documents")
            elif choice == "2":
                print(f"loaded {self.load_documents()} documents")
            elif choice == "3":
                self.save_indices()
                print("indices saved")
            elif choice == "4":
                self.load_indices()
                print("indices loaded")
            elif choice == "5":
                self.verify_system()
            elif choice == "6":
                self.document_count()
            elif choice == "7":
                try:
                    query = input("query: ").strip()
                except EOFError:
                    continue
                if query:
                    self.test_search(query)
            elif choice == "8":
                try:
                    ident = input("document id or url: ").strip()
                except EOFError:
                    continue
                if ident:
                    self.delete_document(ident)
            elif choice == "9":
                break
            else:
                print("unknown option")
        self.manager.cleanup()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="RAG datastore admin tool")
    parser.add_argument("--base-dir", default=".")
    parser.add_argument(
        "--drop", action="store_true",
        help="drop the document store and index artifacts, then exit "
             "(capability parity with reference drop-database.py)",
    )
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = parser.parse_args(argv)
    tool = AdminTool(config=Config.from_env(base_dir=args.base_dir), device=args.device)
    if args.drop:
        tool.manager.reset()
        print("dropped document store and index artifacts")
        tool.manager.cleanup()
        return
    tool.run_menu()


if __name__ == "__main__":
    main()
