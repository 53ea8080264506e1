"""One-way importer for FAISS ``write_index`` flat binaries.

The port's copy of ``rag_faiss_embedding_tpu/index/faiss_import.py`` (pure
numpy; the port imports nothing of the JAX package). A user switching from
the reference arrives with ``data/faiss_index.bin`` and a pickled doc-id list
in ``data/faiss_index.bin.mapping`` (``faiss_store.py:83-97``). This module
reads those files without faiss installed and returns the raw vectors and doc
ids, which :meth:`VectorStore.import_faiss` adds to any index tier. Writing
stays this package's own npz codec: the import is one-way.

Format: little-endian fourcc ``IxF2`` / ``IxFI`` / ``IxFl``, a header of
``int32 d, int64 ntotal, int64 dummy x2, uint8 is_trained, int32
metric_type`` (+ ``float metric_arg`` when metric_type > 1), then the flat
storage as a count-prefixed vector. The count is the number of FLOATS
(ntotal*d, legacy ``xb``) or of BYTES (ntotal*d*4, ``IndexFlatCodes.codes``)
depending on the faiss version; both are taken, by checking which one the
payload matches.

The ``.mapping`` sidecar is a pickled ``list[int]``. Pickle can run code, so
it is loaded through a restricted unpickler that refuses every class lookup:
plain ints and lists need none.
"""

from __future__ import annotations

import io
import pickle
import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..core.logging import get_logger

logger = get_logger(__name__)

_FOURCC_METRIC = {
    b"IxFI": "IP",   # METRIC_INNER_PRODUCT
    b"IxF2": "L2",   # METRIC_L2
    b"IxFl": None,   # generic flat: metric taken from the header field
}
# faiss MetricType enum: 0 = inner product, 1 = L2
_METRIC_ENUM = {0: "IP", 1: "L2"}


class FaissImportError(ValueError):
    """Raised when a file is not a readable FAISS flat index."""


def read_flat_index(path: str | Path) -> Tuple[np.ndarray, str]:
    """Parse a ``faiss.write_index`` IndexFlat binary.

    Returns ``(vectors (ntotal, d) float32, metric "L2"|"IP")``. Only the
    flat family is supported — IVF/PQ/HNSW faiss files raise
    :class:`FaissImportError` with the offending fourcc (re-build those
    from raw vectors with this package's own IVF/PQ tiers instead).
    """
    buf = Path(path).read_bytes()
    if len(buf) < 41:
        raise FaissImportError(f"{path}: too short for a FAISS index header")
    fourcc = buf[:4]
    if fourcc not in _FOURCC_METRIC:
        raise FaissImportError(
            f"{path}: unsupported FAISS index type {fourcc!r} "
            "(only flat IxF2/IxFI/IxFl can be imported)")
    off = 4
    d, = struct.unpack_from("<i", buf, off)
    off += 4
    ntotal, = struct.unpack_from("<q", buf, off)
    off += 8 + 16  # ntotal + two deprecated idx_t dummies
    is_trained = buf[off]
    off += 1
    metric_enum, = struct.unpack_from("<i", buf, off)
    off += 4
    if metric_enum > 1:
        off += 4  # float metric_arg, only serialized for extended metrics
    metric = _FOURCC_METRIC[fourcc] or _METRIC_ENUM.get(metric_enum)
    if metric is None:
        raise FaissImportError(
            f"{path}: unsupported metric_type {metric_enum}")
    if d <= 0 or ntotal < 0 or not is_trained:
        raise FaissImportError(
            f"{path}: implausible header d={d} ntotal={ntotal} "
            f"trained={is_trained}")
    count, = struct.unpack_from("<Q", buf, off)
    off += 8
    n_floats = ntotal * d
    remaining = len(buf) - off
    if count == n_floats and remaining >= n_floats * 4:
        pass  # legacy float-count convention (the bundled artifact)
    elif count == n_floats * 4 and remaining >= n_floats * 4:
        pass  # codes-as-bytes convention
    else:
        raise FaissImportError(
            f"{path}: storage count {count} matches neither {n_floats} "
            f"floats nor {n_floats * 4} bytes (payload {remaining} B)")
    vecs = np.frombuffer(buf, dtype="<f4", count=n_floats, offset=off)
    return vecs.reshape(ntotal, d).copy(), metric


class _IntsOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):  # pragma: no cover - security guard
        raise pickle.UnpicklingError(
            f"mapping sidecar tried to load {module}.{name}; only plain "
            "int lists are accepted")


def read_mapping(path: str | Path) -> List[int]:
    """Load the pickled doc-id list sidecar (restricted unpickler)."""
    data = Path(path).read_bytes()
    obj = _IntsOnlyUnpickler(io.BytesIO(data)).load()
    if not isinstance(obj, (list, tuple)) or not all(
            isinstance(i, int) for i in obj):
        raise FaissImportError(f"{path}: mapping is not a list of ints")
    return list(obj)


def import_faiss_index(
    path: str | Path,
    mapping_path: Optional[str | Path] = None,
) -> Tuple[np.ndarray, List[int], str]:
    """Read a reference FAISS flat index + id mapping.

    ``mapping_path`` defaults to ``<path>.mapping`` (the reference's
    sidecar convention, ``faiss_store.py:92``); when the sidecar is
    missing, ids fall back to sequential ``0..ntotal-1`` exactly like the
    reference's loader (``faiss_store.py:108-116``).

    Returns ``(vectors, doc_ids, metric)``.
    """
    path = Path(path)
    vecs, metric = read_flat_index(path)
    mp = Path(mapping_path) if mapping_path is not None else Path(
        str(path) + ".mapping")
    if mp.exists():
        ids = read_mapping(mp)
        if len(ids) != len(vecs):
            raise FaissImportError(
                f"{mp}: {len(ids)} ids for {len(vecs)} vectors")
    else:
        logger.warning("no mapping sidecar at %s; using sequential ids", mp)
        ids = list(range(len(vecs)))
    logger.info("imported FAISS flat index %s: %d x %d (%s)",
                path, vecs.shape[0], vecs.shape[1], metric)
    return vecs, ids, metric
