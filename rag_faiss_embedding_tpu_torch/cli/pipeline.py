"""Ingestion pipeline: HTML corpus -> documents.json -> db + index.

Counterpart of ``rag_faiss_embedding_tpu/cli/pipeline.py``: this package's
``HtmlIngestor`` (no BeautifulSoup) and ``RAGManager`` (on ``--device``).
Capability parity with ``1-rag-faiss-sqlite-pipeline.sh`` (which chains
``process_unstructured_html.py`` and ``rag_datastore_manager.py``) plus the
HTML processor's CLI flags (``process_unstructured_html.py:290-326``:
--output-dir, --debug, --max-content-length, --max-sentences). The
reference's pipeline unconditionally deletes the db/index first
(``rag_datastore_manager.py:244-253``); here that's the default too but can
be disabled with --no-reset for incremental runs.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..core.config import Config
from ..core.logging import configure, get_logger
from ..ingest.html import HtmlIngestor
from ..rag.manager import RAGManager
from ..utils.timers import StageTimer

logger = get_logger(__name__)


def run_pipeline(
    base_dir: str = ".",
    html_root: Optional[str] = None,
    url_prefix: str = "",
    max_content_length: int = 512,
    max_sentences: int = 2,
    reset: bool = True,
    config: Optional[Config] = None,
    manager: Optional[RAGManager] = None,
    device=None,
) -> int:
    cfg = config or Config.from_env(base_dir=base_dir)
    cfg.setup_directories()
    timer = StageTimer()

    with timer.stage("ingest_html"):
        ingestor = HtmlIngestor(
            output_dir=cfg.data_dir,
            url_prefix=url_prefix,
            max_content_length=max_content_length,
            max_sentences=max_sentences,
        )
        entries = ingestor.generate_index(root=html_root or cfg.base_dir)
    if not entries:
        logger.warning("ingestion produced no documents")

    manager = manager or RAGManager(config=cfg, device=device)
    if reset:
        with timer.stage("reset"):
            manager.reset()
    with timer.stage("embed_and_index"):
        n = manager.initialize_database()
    logger.info("pipeline complete: %d documents indexed", n)
    print(timer.report())
    return n


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Ingest HTML corpus and build the vector index",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--base-dir", default=".")
    parser.add_argument("--html-root", default=None,
                        help="directory to scan for *.html (default: base dir)")
    parser.add_argument("--url-prefix", default="")
    parser.add_argument("--max-content-length", type=int, default=512)
    parser.add_argument("--max-sentences", type=int, default=2)
    parser.add_argument("--no-reset", action="store_true",
                        help="keep existing db/index (incremental)")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = parser.parse_args(argv)
    if args.debug:
        configure(level="DEBUG")
    run_pipeline(
        base_dir=args.base_dir,
        html_root=args.html_root,
        url_prefix=args.url_prefix,
        max_content_length=args.max_content_length,
        max_sentences=args.max_sentences,
        reset=not args.no_reset,
        device=args.device,
    )


if __name__ == "__main__":
    main()
