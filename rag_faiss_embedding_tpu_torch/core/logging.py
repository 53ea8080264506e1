"""Structured logging on stdlib ``logging``.

A copy of ``rag_faiss_embedding_tpu/core/logging.py``: the same format and
sinks, under this package's logger name.

Capability parity with the reference's loguru setup (colored console format +
rotating file sink, ``config.py:40-42``, ``document_validator.py:17-22``)
without the loguru dependency. Unlike the reference — which logs at INFO in
the search hot path (``faiss_store.py:52-76``) — hot-path modules here log at
DEBUG so serving latency is not spent formatting strings.
"""

from __future__ import annotations

import logging
import logging.handlers
import sys
from pathlib import Path
from typing import Optional

_CONFIGURED = False
_ROOT = "rag_faiss_embedding_tpu_torch"

_COLORS = {
    "DEBUG": "\x1b[36m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "CRITICAL": "\x1b[41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, "")
            return f"{color}{base}{_RESET}"
        return base


def configure(level: str = "INFO", log_file: Optional[Path] = None) -> None:
    """Configure root handlers once; safe to call repeatedly."""
    global _CONFIGURED
    root = logging.getLogger(_ROOT)
    if _CONFIGURED:
        root.setLevel(level.upper())
        return
    root.setLevel(level.upper())
    fmt = "%(asctime)s | %(levelname)-8s | %(name)s:%(funcName)s:%(lineno)d - %(message)s"
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(_ColorFormatter(fmt, datefmt="%Y-%m-%d %H:%M:%S"))
    root.addHandler(console)
    if log_file is not None:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        # 500 MB rotation, matching the reference's loguru sink (config.py:42)
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=500 * 1024 * 1024, backupCount=3
        )
        fh.setFormatter(logging.Formatter(fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        root.addHandler(fh)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    configure()
    short = name.removeprefix(f"{_ROOT}.")
    return logging.getLogger(f"{_ROOT}.{short}")
