"""Native (C++) host-side components, loaded via ctypes.

A copy of ``rag_faiss_embedding_tpu/native/__init__.py`` over this package's
copy of ``tokenizer.cpp``: the fast WordPiece tokenizer used on the serving
hot path. The shared library is built with the host C++ compiler (``$CXX``,
else ``g++``) the first time it is requested, into ``_build/`` inside this
package, keyed by a hash of the source and the flags. A failed build leaves
the Python tokenizer in charge: every native component has an exact-parity
Python fallback, so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.logging import get_logger

logger = get_logger(__name__)

_SRC = Path(__file__).parent / "tokenizer.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def _library_path() -> Path:
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / digest / "libwptok.so"


def build_native(force: bool = False) -> Optional[Path]:
    """Compile the shared library if missing; returns its path or None."""
    so = _library_path()
    if so.exists() and not force:
        return so
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            subprocess.run(
                [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, str(_SRC)],
                check=True, capture_output=True, text=True, timeout=120,
            )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return so
    except Exception as e:
        logger.debug("native tokenizer build failed: %s", e)
        return None


class NativeWordPiece:
    """ctypes wrapper over tokenizer.cpp with Python-fallback contract:
    ``encode`` returns None when the native path can't handle the text
    (non-ASCII), and the caller must use the Python implementation."""

    def __init__(self, vocab: dict, lowercase: bool = True):
        so = build_native()
        if so is None:
            raise RuntimeError("native tokenizer unavailable")
        self._lib = ctypes.CDLL(str(so))
        self._lib.wp_create.restype = ctypes.c_void_p
        self._lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        self._lib.wp_free.argtypes = [ctypes.c_void_p]
        self._lib.wp_encode.restype = ctypes.c_int32
        self._lib.wp_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        self._lib.wp_encode_batch.restype = ctypes.c_int32
        self._lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        items = sorted(vocab.items(), key=lambda kv: kv[1])
        lines = "\n".join(tok for tok, _ in items)
        self._handle = self._lib.wp_create(lines.encode("utf-8"),
                                           1 if lowercase else 0)
        self.pad_id = vocab.get("[PAD]", 0)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.wp_free(self._handle)
        except Exception:
            pass

    def encode(self, text: str, max_length: int = 512) -> Optional[List[int]]:
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        buf = (ctypes.c_int32 * max_length)()
        n = self._lib.wp_encode(self._handle, raw, max_length, buf)
        if n < 0:
            return None
        return list(buf[:n])

    def encode_batch(
        self, texts: Sequence[str], max_length: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, mask, fallback_flags); rows flagged 1 must be re-encoded by
        the Python path."""
        try:
            blob = b"\0".join(t.encode("ascii") for t in texts) + b"\0"
        except UnicodeEncodeError:
            return None, None, np.ones(len(texts), np.int32)
        n = len(texts)
        ids = np.empty((n, max_length), np.int32)
        mask = np.empty((n, max_length), np.int32)
        flags = np.empty((n,), np.int32)
        self._lib.wp_encode_batch(
            self._handle, blob, n, max_length, self.pad_id,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return ids, mask, flags
