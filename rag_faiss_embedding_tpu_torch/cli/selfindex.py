"""Self-indexing utility: index this repo's own Python files.

Counterpart of ``rag_faiss_embedding_tpu/cli/selfindex.py`` (its
``RAGManager`` on ``--device``). Capability parity with ``initialize_rag.py``: glob ``**/*.py``, insert into
the doc store (autoincrement ids by url), embed contents, reset + add to the
vector index, save. Useful as a quick smoke corpus.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

from ..core.config import Config
from ..core.logging import get_logger
from ..rag.manager import RAGManager

logger = get_logger(__name__)


def process_python_files(directory: str | Path = ".") -> List[Dict]:
    """Collect .py files as documents (``initialize_rag.py:14-30``)."""
    documents = []
    root = Path(directory)
    for path in sorted(root.rglob("*.py")):
        try:
            content = path.read_text(encoding="utf-8")
        except Exception as e:
            logger.error("error processing %s: %s", path, e)
            continue
        rel = str(path.relative_to(root))
        documents.append({"url": rel, "title": path.name, "content": content})
    return documents


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Index this repo's .py files")
    parser.add_argument("--base-dir", default=".")
    parser.add_argument("--source-dir", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = parser.parse_args(argv)
    cfg = Config.from_env(base_dir=args.base_dir)
    manager = RAGManager(config=cfg, device=args.device)
    documents = process_python_files(args.source_dir or args.base_dir)
    logger.info("found %d Python files", len(documents))
    manager.vector_store.reset()
    n = manager.initialize_database(documents)
    logger.info("initialized RAG system with %d documents", n)
    manager.cleanup()


if __name__ == "__main__":
    main()
