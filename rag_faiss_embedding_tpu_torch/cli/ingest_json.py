"""Batch JSON ingestion: validate -> store -> embed -> index.

Counterpart of ``rag_faiss_embedding_tpu/cli/ingest_json.py``, through this
package's ``DocumentValidator`` and ``RAGManager`` (on ``--device``).
Capability parity with the reference's ``data_ingestion.py`` (reads
``data/search-index.json``, validates, batch-stores — though its
``db.batch_store_documents`` call targets the MongoDB-era API that no longer
exists, SURVEY.md §2 row 12; this version actually works) combined with the
validator stage of ``document_validator.py``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

from ..core.config import Config
from ..core.logging import get_logger
from ..ingest.validator import DocumentValidator
from ..rag.manager import RAGManager

logger = get_logger(__name__)


def ingest_json(
    manager: RAGManager,
    input_path: str | Path,
    validate: bool = True,
    summarization_method: str = "basic",
) -> int:
    documents = json.loads(Path(input_path).read_text())
    logger.info("loaded %d raw documents from %s", len(documents), input_path)
    if validate:
        validator = DocumentValidator(
            summarization_method=summarization_method,
            embedder=manager.embedder if summarization_method == "embed" else None,
        )
        documents = validator.batch_validate_documents(documents)
    n = manager.add_documents(documents)
    manager.vector_store.save_index()
    logger.info("ingested %d documents", n)
    return n


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Ingest a JSON document corpus into the store + index"
    )
    parser.add_argument("--base-dir", default=".")
    parser.add_argument("--input", default=None,
                        help="input JSON (default: config search_index_json)")
    parser.add_argument("--no-validate", action="store_true")
    parser.add_argument("--method", default="basic",
                        choices=["basic", "textrank", "embed", "transformers"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = parser.parse_args(argv)
    cfg = Config.from_env(base_dir=args.base_dir)
    manager = RAGManager(config=cfg, device=args.device)
    ingest_json(
        manager,
        args.input or cfg.search_index_json,
        validate=not args.no_validate,
        summarization_method=args.method,
    )
    manager.cleanup()


if __name__ == "__main__":
    main()
