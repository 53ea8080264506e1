"""Vector store: index + document-id mapping + persistence.

Counterpart of ``rag_faiss_embedding_tpu/index/vector_store.py`` (the
reference's ``FAISSVectorStore``, ``faiss_store.py:10-128``): the
position -> doc-id mapping kept beside the index, search returning mapped doc
ids with invalid (-1) slots dropped, ``save_index`` writing the npz payload
plus a JSON ``.mapping`` sidecar, ``load_index`` falling back to sequential
ids without the sidecar, ``remove_doc_ids`` and ``allowed_doc_ids``
filtering. The files are the JAX package's format: each package loads the
other's.

Every index kind of the JAX package loads: "flat" (float32, bfloat16,
int8), "ivf" (dense and IVF-PQ), "pq", and the sharded kinds
"sharded_flat" (``parallel.sharded.ShardedFlatIndex``) and "sharded_ivf"
(``parallel.sharded_ivf.ShardedIVFIndex``), which load onto ``mesh``: by
default every visible card for a CUDA store, one CPU device for a CPU store.
An int8 flat file with a bf16 shadow reloads with selector "rerank" and its
shadow (the JAX store reloads it as "exact" and drops the shadow).
``import_faiss`` reads a reference FAISS flat binary (``index/faiss_import``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.mesh import Mesh, make_mesh
from ..utils.timers import span

from .faiss_import import import_faiss_index
from .flat import FlatIndex
from .ivf import IVFFlatIndex
from .pq import PQIndex

logger = get_logger(__name__)


class VectorStore:
    def __init__(
        self,
        dimension: int = 384,
        metric: str = "L2",
        index_path: str | Path = "data/index.tpu",
        dtype: str = "float32",
        index: Optional[FlatIndex | IVFFlatIndex | PQIndex] = None,
        selector: str = "exact",
        mesh: Optional[Mesh] = None,
        device: Optional[torch.device | str] = None,
    ):
        self.dimension = dimension
        self.metric = metric
        self.index_path = Path(index_path)
        # the mesh a sharded index kind loads onto (None: see _load_mesh)
        self._mesh = mesh
        self.doc_ids: List[int] = []
        self.index = index if index is not None else FlatIndex(
            dimension, metric=metric, dtype=dtype, selector=selector,
            device=device,
        )
        self.device = self.index.device
        if self.index_path.exists():
            self.load_index()

    @property
    def ntotal(self) -> int:
        return self.index.ntotal

    @property
    def nlive(self) -> int:
        """Searchable vectors (``ntotal`` minus ``remove_ids`` tombstones)."""
        return self.index.nlive

    def add_vectors(self, vectors: np.ndarray, ids: Sequence[int]) -> None:
        """Add vectors with their document ids (``faiss_store.py:36-47``)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors.reshape(1, -1)
        if len(ids) != len(vectors):
            raise ValueError(f"{len(vectors)} vectors but {len(ids)} ids")
        with span("index.add", rows=len(ids)):
            self.doc_ids.extend(int(i) for i in ids)
            self.index.add(vectors)
        logger.debug("added %d vectors (ntotal=%d)", len(ids), self.ntotal)

    def import_faiss(self, path: str | Path,
                     mapping_path: Optional[str | Path] = None) -> int:
        """Migrate a reference ``faiss.write_index`` flat binary into this
        store (one-way; see :mod:`.faiss_import`). The file's metric and
        width must match the store's. Returns the number of vectors
        imported."""
        vecs, ids, metric = import_faiss_index(path, mapping_path)
        if metric != self.metric:
            raise ValueError(f"FAISS file is {metric} but this store is {self.metric}")
        if vecs.shape[1] != self.dimension:
            raise ValueError(f"FAISS file is {vecs.shape[1]}-d but this store is "
                             f"{self.dimension}-d")
        self.add_vectors(vecs, ids)
        return len(ids)

    def search(
        self,
        query_vectors: np.ndarray,
        k: int = 5,
        allowed_doc_ids: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, List[List[int]]]:
        """Search and map row positions to document ids.

        A single vector gives (distances, doc_ids); a batch gives lists of
        both, one per query. Invalid slots are dropped.
        ``allowed_doc_ids``: optional allowlist of DOCUMENT ids, turned into
        a row mask through the id mapping and applied inside the scan.
        """
        q = np.asarray(query_vectors, dtype=np.float32)
        single = q.ndim == 1
        if single:
            q = q.reshape(1, -1)
        with span("vector_store.search", queries=len(q), k=k):
            kwargs = {}
            if allowed_doc_ids is not None:
                allowed = {int(i) for i in allowed_doc_ids}
                mask = np.fromiter(
                    (d in allowed for d in self.doc_ids),
                    dtype=bool, count=len(self.doc_ids),
                )
                n = self.index.ntotal
                if len(mask) < n:  # defensive: sequential-id fallback mapping
                    mask = np.pad(mask, (0, n - len(mask)))
                kwargs["filter_mask"] = mask[:n]
            with span("index.search"):
                values, indices = self.index.search(q, k, **kwargs)
            with span("vector_store.to_host"):  # the host waits for the card here
                values = values.cpu().numpy()
                indices = indices.cpu().numpy()
            all_ids: List[List[int]] = []
            all_dists: List[np.ndarray] = []
            with span("vector_store.map_ids") as s:
                for row_v, row_i in zip(values, indices):
                    ids, dists = [], []
                    for v, i in zip(row_v, row_i):
                        if i != -1 and i < len(self.doc_ids):
                            ids.append(self.doc_ids[int(i)])
                            dists.append(float(v))
                    all_ids.append(ids)
                    all_dists.append(np.asarray(dists, dtype=np.float32))
                if s:
                    s.add(hits=sum(map(len, all_ids)))
        if single:
            return all_dists[0], all_ids[0]
        return all_dists, all_ids

    def remove_doc_ids(self, doc_ids: Sequence[int]) -> int:
        """Remove all vectors mapped to the given document ids. Positions
        stay stable; removed slots become -1 in the mapping. Returns the
        number of vectors removed."""
        wanted = {int(i) for i in doc_ids}
        positions = [p for p, d in enumerate(self.doc_ids) if d in wanted]
        if not positions:
            return 0
        removed = self.index.remove_ids(np.asarray(positions, np.int64))
        for p in positions:
            self.doc_ids[p] = -1
        logger.debug("removed %d vectors for %d doc ids", removed, len(wanted))
        return int(removed)

    # ------------------------------------------------------------------ io
    def save_index(self, filepath: Optional[str | Path] = None) -> None:
        """Persist index payload + ``.mapping`` sidecar (``faiss_store.py:83-97``)."""
        path = Path(filepath or self.index_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        state = self.index.state_dict()
        np.savez_compressed(path, **{k: np.asarray(v) for k, v in state.items()})
        # np.savez appends .npz unless present; normalize to the exact path.
        written = path if path.suffix == ".npz" else path.with_name(path.name + ".npz")
        if written != path:
            written.replace(path)
        Path(str(path) + ".mapping").write_text(json.dumps(self.doc_ids))
        logger.info("saved index (%d vectors) to %s", self.ntotal, path)

    def load_index(self, filepath: Optional[str | Path] = None) -> None:
        """Load index + mapping onto this store's device; sequential-id
        fallback if the sidecar is missing (``faiss_store.py:99-122``)."""
        path = Path(filepath or self.index_path)
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        kind = str(state["kind"])
        if kind == "flat":
            self.index = FlatIndex.from_state_dict(
                {k: (v if k == "vectors" else v.item() if v.ndim == 0 else v)
                 for k, v in state.items()},
                device=self.device,
            )
        elif kind == "ivf":
            self.index = IVFFlatIndex.from_state_dict(state, device=self.device)
        elif kind == "pq":
            self.index = PQIndex.from_state_dict(state, device=self.device)
        elif kind == "sharded_flat":
            from ..parallel.sharded import ShardedFlatIndex

            self.index = ShardedFlatIndex.from_state_dict(state, mesh=self._load_mesh())
        elif kind == "sharded_ivf":
            from ..parallel.sharded_ivf import ShardedIVFIndex

            self.index = ShardedIVFIndex.from_state_dict(state, mesh=self._load_mesh())
        else:
            raise ValueError(f"unknown index kind {kind!r}")
        self.dimension = self.index.dim
        self.metric = self.index.metric
        mapping_path = Path(str(path) + ".mapping")
        if mapping_path.exists():
            self.doc_ids = [int(i) for i in json.loads(mapping_path.read_text())]
            logger.info("loaded id mapping for %d documents", len(self.doc_ids))
        else:
            self.doc_ids = list(range(self.index.ntotal))
            logger.warning("no mapping sidecar; using sequential ids")
        logger.info("loaded index from %s (%d vectors)", path, self.ntotal)

    def _load_mesh(self) -> Mesh:
        """The mesh given, else every visible card on a "db" axis for a CUDA
        store and one device for a CPU store."""
        if self._mesh is not None:
            return self._mesh
        if self.device.type == "cpu":
            return make_mesh({"db": 1}, devices=[self.device])
        return make_mesh()

    def reset(self) -> None:
        self.index.reset()
        self.doc_ids = []
        logger.info("reset vector store")
