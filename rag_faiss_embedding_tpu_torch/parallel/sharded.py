"""Sharded exact (flat) search: one top-k per shard, then a merge.

Counterpart of ``rag_faiss_embedding_tpu/parallel/sharded.py`` (BASELINE.md
config #4, a 10M x 384 flat scan split over devices):

- database rows are split over the ``"db"`` mesh axis: shard ``j`` holds the
  contiguous global rows ``[j * rows_per_dev, (j + 1) * rows_per_dev)`` and
  their squared norms, as its own tensors on its device; a ``"data"`` axis
  splits the queries, and each of its rows searches its own copy of the
  shards;
- each shard runs the flat-scan wrapper (``ops/flat_scan.flat_search``): on
  a CUDA shard the kernel (``csrc/flat_scan.cu``, one launch per shard per
  search), on a CPU shard its plain version. Its contract is JAX's
  ``_exact_search_impl``: rows past ``n_valid`` and ``dead`` rows never
  return, and ties go to the lowest row;
- the shards' (k values, k global ids) are copied to the first db device,
  concatenated in db-axis order and selected again with ties to the lowest
  position, so an exact tie goes to the lower shard, as JAX's all-gather
  and ``lax.top_k`` give it. ``k`` past ``rows_per_dev`` pads with inf /
  -inf and id -1.

JAX's all-gather rides the interconnect; here the merge is a copy of k
candidates per query and shard to the first device (nothing moves where the
shards share a card).

The order of a search's work is what lets the shards scan at once. Every
shard's copy of the query is made before the first kernel launch: a copy
from one card to another runs on the source card's stream, so made after
that card's launch it would wait behind its scan. ``ShardedFlatIndex``
leaves a query from the host there, so each card's copy comes straight
from the host. The launches then follow each other with no other host
work between them, and the global-id offsets and the merge come after the
last.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.mesh import Mesh, make_mesh, sharding
from ..index import codec
from ..index.flat import _DTYPES, _dtype_name
from ..ops import distance as dist_ops
from ..ops import flat_scan
from ..utils.timers import span

logger = get_logger(__name__)


def _fill(metric: str) -> float:
    return float("inf") if metric == "L2" else float("-inf")


def merge_shards(parts, k: int, metric: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard (values, global ids) on ``device``: concatenated in
    shard order, the top ``min(k, columns)`` by score (L2 ascending, IP
    descending; id -1 never wins), ties to the lowest position; values of
    empty slots become inf / -inf. One stable descending sort selects them,
    in the order ``small_topk``'s k argmax passes give, in a few ops."""
    vals = torch.cat([v.to(device) for v, _ in parts], 1)
    ids = torch.cat([i.to(device) for _, i in parts], 1)
    scores = torch.where(ids >= 0, -vals if metric == "L2" else vals, dist_ops.NEG_INF)
    pos = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    out_i = ids.gather(1, pos)
    return torch.where(out_i >= 0, vals.gather(1, pos), _fill(metric)), out_i


def pad_to_k(vals: torch.Tensor, ids: torch.Tensor, k: int, metric: str):
    """Pad (values, ids) columns to ``k`` with inf / -inf and -1."""
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), _fill(metric))], 1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), -1)], 1)
    return vals, ids


def _positions(mesh: Mesh, db_axis: str, data_axis: Optional[str]) -> list:
    """Mesh positions of the shards, one list per data row (one row without
    ``data_axis``), each in db-axis order; every other axis at position 0."""
    names = mesh.axis_names
    n_data = mesh.shape[data_axis] if data_axis is not None else 1

    def pos(i, j):
        return tuple(j if a == db_axis else i if a == data_axis else 0 for a in names)

    return [[pos(i, j) for j in range(mesh.shape[db_axis])] for i in range(n_data)]


def _shards(x, mesh: Mesh, rows: list, db_axis: str, n_rows: int, dtype=None) -> list:
    """Per-shard tensors of each data row (``rows``: ``_positions``), each
    on its position's device. A global tensor is split over ``db_axis`` and
    placed straight there; a list of per-shard tensors, or one such list per
    data row, is moved where it does not lie there already (so a caller
    that keeps a copy per data row moves nothing); ``None`` gives ``None``s."""
    if x is None:
        return [[None] * len(r) for r in rows]
    if isinstance(x, (list, tuple)):
        per_row = x if isinstance(x[0], (list, tuple)) else [x] * len(rows)
        return [[s.to(mesh.devices[p]) for s, p in zip(shards, r)]
                for shards, r in zip(per_row, rows)]
    x = dist_ops.as_tensor(x, dtype=dtype)
    if x.shape[0] != n_rows:
        raise ValueError(f"{x.shape[0]} entries for {n_rows} rows")
    place = sharding(mesh, db_axis)
    return [[place.part(x, p) for p in r] for r in rows]


def sharded_exact_search(
    mesh: Mesh,
    q,
    db,
    k: int,
    *,
    metric: str = "L2",
    db_sq=None,
    n_valid: Optional[int] = None,
    chunk_size: int = 65536,
    db_axis: str = "db",
    data_axis: Optional[str] = None,
    selector: str = "exact",
    dead=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded database.

    ``db`` is a (n_dev * rows_per_dev, dim) tensor (split over ``db_axis``
    here), or the list of its per-shard tensors, or with ``data_axis`` one
    such list per data row, each shard on its device of the mesh; ``db_sq``
    and ``dead`` likewise. ``q`` is searched whole by every shard, or split
    over ``data_axis`` when one is given, each part by its data row's copy
    of the shards. Returns (values, indices) on the first db device, with
    the contract of ``ops.distance.exact_search``; ``chunk_size`` is the
    plain version's rows per step (CPU shards)."""
    if metric not in ("L2", "IP"):
        raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
    if selector not in ("exact", "approx"):
        raise ValueError(f"selector must be 'exact' or 'approx', got {selector!r}")
    n_dev = mesh.shape[db_axis]
    rows = _positions(mesh, db_axis, data_axis)
    if isinstance(db, (list, tuple)):
        first = db[0] if isinstance(db[0], (list, tuple)) else db
        if len(first) != n_dev:
            raise ValueError(f"{len(first)} shards for mesh axis {db_axis}={n_dev}")
        n = sum(int(s.shape[0]) for s in first)
    else:
        db = dist_ops.as_tensor(db)
        n = int(db.shape[0])
        if n % n_dev:
            raise ValueError(f"db rows {n} must divide mesh axis {db_axis}={n_dev}")
        if db_sq is None and metric == "L2":
            db_sq = dist_ops.sqnorms(db)
    shards = _shards(db, mesh, rows, db_axis, n)
    sq = _shards(db_sq, mesh, rows, db_axis, n)
    dd = _shards(dead, mesh, rows, db_axis, n, dtype=torch.bool)
    rows_per_dev = int(shards[0][0].shape[0])
    k_eff = min(k, rows_per_dev)  # each shard contributes at most its rows
    nv = n if n_valid is None else int(n_valid)
    chunk_size = min(chunk_size, rows_per_dev)

    q = dist_ops.as_tensor(q)
    if q.shape[0] % len(rows):
        raise ValueError(f"{q.shape[0]} queries do not split over {data_axis}={len(rows)}")
    step = q.shape[0] // len(rows)
    home = mesh.devices[rows[0][0]]
    live = [min(max(nv - j * rows_per_dev, 0), rows_per_dev) for j in range(n_dev)]
    queries = []
    for i, r in enumerate(rows):
        with span("sharded.query_copy", cards=len(r)):
            qg = q[i * step:(i + 1) * step]
            queries.append([qg.to(mesh.devices[p]) for p in r])
    found = [[] for _ in rows]
    for i, r in enumerate(rows):
        for j in range(len(r)):
            with span("sharded.shard_scan", shard=j, rows=live[j]):
                found[i].append(flat_scan.flat_search(
                    queries[i][j], shards[i][j], k_eff, metric=metric, db_sq=sq[i][j],
                    n_valid=live[j], dead=dd[i][j], chunk_size=chunk_size))
    out_v, out_i = [], []
    for i, r in enumerate(rows):
        with span("sharded.merge", shards=len(r), candidates=len(r) * k_eff):
            parts = [(v, torch.where(ix >= 0, ix + j * rows_per_dev, -1) if j else ix)
                     for j, (v, ix) in enumerate(found[i])]  # global ids; -1 stays
            v, ix = merge_shards(parts, k, metric, mesh.devices[r[0]])
            out_v.append(v.to(home))
            out_i.append(ix.to(home))
    return pad_to_k(torch.cat(out_v), torch.cat(out_i), k, metric)


class ShardedFlatIndex:
    """Flat exact index with rows sharded over a device mesh.

    Multi-device counterpart of ``index.flat.FlatIndex``: the same add /
    search / remove / reset contract, with each device of the ``db`` axis
    holding a contiguous row range of a buffer whose capacity is a multiple
    of 1024 rows per device. float32 or bfloat16 storage."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        metric: str = "L2",
        dtype: str | torch.dtype = "float32",
        capacity: int = 8192,
        db_axis: str = "db",
        selector: str = "exact",
    ):
        if metric not in ("L2", "IP"):
            raise ValueError(f"metric must be 'L2' or 'IP', got {metric!r}")
        if selector not in ("exact", "approx"):
            raise ValueError(f"selector must be 'exact' or 'approx', got {selector!r}")
        self.dim = int(dim)
        self.mesh = mesh
        self.metric = metric
        self.dtype_name = _dtype_name(dtype)
        if self.dtype_name == "int8":
            raise ValueError("the sharded flat index stores float32 or bfloat16 rows")
        self.dtype = _DTYPES[self.dtype_name]
        self.db_axis = db_axis
        self.selector = selector
        self.n_dev = mesh.shape[db_axis]
        self.devices = mesh.axis_devices(db_axis)
        self.device = self.devices[0]  # where results land
        self.ntotal = 0
        self._capacity = self._round_cap(capacity)
        per = self._capacity // self.n_dev
        self._buf = [torch.zeros((per, self.dim), dtype=self.dtype, device=d)
                     for d in self.devices]
        self._sq = [torch.zeros((per,), dtype=torch.float32, device=d) for d in self.devices]
        # tombstones (remove_ids), per shard; allocated on first removal
        self._dead: Optional[list] = None
        self.ndeleted = 0

    def _round_cap(self, cap: int) -> int:
        per_dev = -(-cap // self.n_dev)
        per_dev = max(1024, -(-per_dev // 1024) * 1024)
        return per_dev * self.n_dev

    @property
    def _rows_per_dev(self) -> int:
        return self._capacity // self.n_dev

    def _grow(self, needed: int) -> None:
        """Double the capacity until ``needed`` rows fit. Rows keep their
        global positions (the id mapping is positional), so the shard
        boundaries move: each new shard gathers its rows from the old
        shards that held them, device to device."""
        if needed <= self._capacity:
            return
        new_cap = self._capacity
        while new_cap < needed:
            new_cap *= 2
        old_per, new_per = self._rows_per_dev, new_cap // self.n_dev

        def regrid(shards):
            out = []
            for j, dev in enumerate(self.devices):
                lo, hi = j * new_per, (j + 1) * new_per
                pieces = []
                for s, t in enumerate(shards):
                    a, b = max(lo, s * old_per), min(hi, (s + 1) * old_per)
                    if a < b:
                        pieces.append(t[a - s * old_per:b - s * old_per].to(dev))
                have = sum(p.shape[0] for p in pieces)
                pieces.append(shards[0].new_zeros((new_per - have,) + shards[0].shape[1:],
                                                  device=dev))
                out.append(torch.cat(pieces))
            return out

        self._buf, self._sq = regrid(self._buf), regrid(self._sq)
        if self._dead is not None:
            self._dead = regrid(self._dead)
        self._capacity = new_cap
        logger.debug("grew sharded index capacity to %d rows (device to device)", new_cap)

    def _spans(self, lo: int, hi: int):
        """(shard, local start, local stop, offset into [lo, hi)) of every
        shard that global rows [lo, hi) touch."""
        per = self._rows_per_dev
        for j in range(lo // per, min(self.n_dev, -(-hi // per))):
            a, b = max(lo, j * per), min(hi, (j + 1) * per)
            if a < b:
                yield j, a - j * per, b - j * per, a - lo

    def add(self, vectors) -> None:
        """Append vectors at the watermark, each row into its shard."""
        vecs = dist_ops.as_tensor(vectors)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape[-1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {vecs.shape[-1]}")
        n_new = vecs.shape[0]
        self._grow(self.ntotal + n_new)
        for j, a, b, off in self._spans(self.ntotal, self.ntotal + n_new):
            rows = vecs[off:off + b - a].to(device=self.devices[j], dtype=self.dtype)
            self._buf[j][a:b] = rows
            self._sq[j][a:b] = dist_ops.sqnorms(rows)
        self.ntotal += n_new

    def search(self, queries, k: int, chunk_size: int = 65536,
               filter_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k over the live rows, merged over the shards; (values,
        indices) on the first db device. ``filter_mask``: optional (ntotal,)
        bool, True = searchable, OR-ed (negated) into each shard's
        tombstones."""
        q = dist_ops.as_tensor(queries)
        if q.ndim == 1:
            q = q[None, :]
        if self.ntotal == 0:
            nq = q.shape[0]
            return (torch.full((nq, k), _fill(self.metric), device=self.device),
                    torch.full((nq, k), -1, dtype=torch.int32, device=self.device))
        dead = self._dead
        if filter_mask is not None:
            block = ~dist_ops.as_tensor(filter_mask, self.device, torch.bool)
            if block.shape[0] != self.ntotal:
                raise ValueError(f"filter_mask has {block.shape[0]} entries, "
                                 f"index has {self.ntotal}")
            block = torch.cat([block, block.new_zeros(self._capacity - self.ntotal)])
            per = self._rows_per_dev
            blocks = [block[j * per:(j + 1) * per].to(d) for j, d in enumerate(self.devices)]
            dead = blocks if dead is None else [a | b for a, b in zip(dead, blocks)]
        return sharded_exact_search(
            self.mesh, q.to(dtype=self.dtype), self._buf, k,
            metric=self.metric, db_sq=self._sq, n_valid=self.ntotal, chunk_size=chunk_size,
            db_axis=self.db_axis, selector=self.selector, dead=dead)

    @property
    def nlive(self) -> int:
        """Rows that remain searchable (``ntotal`` minus tombstones)."""
        return self.ntotal - self.ndeleted

    def remove_ids(self, ids) -> int:
        """Tombstone rows by position (``faiss.Index.remove_ids`` analog),
        each in its shard's mask; positions stay stable. Returns the number
        of rows newly removed."""
        pos = np.unique(np.asarray(ids, np.int64).ravel())
        pos = pos[(pos >= 0) & (pos < self.ntotal)]
        if not len(pos):
            return 0
        if self._dead is None:
            self._dead = [torch.zeros_like(s, dtype=torch.bool) for s in self._sq]
        per = self._rows_per_dev
        newly = 0
        for j in np.unique(pos // per):
            local = torch.as_tensor(pos[pos // per == j] - j * per, device=self.devices[j])
            newly += int(local.numel() - int(self._dead[j][local].sum()))
            self._dead[j][local] = True
        self.ndeleted += newly
        logger.debug("tombstoned %d rows (%d live)", newly, self.nlive)
        return newly

    def reset(self) -> None:
        self.ntotal = 0
        self.ndeleted = 0
        self._dead = None
        for t in self._buf + self._sq:
            t.zero_()

    def _rows(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """Global rows [0, ntotal) of per-shard tensors, on the host."""
        parts = [shards[j][a:b].cpu() for j, a, b, _ in self._spans(0, self.ntotal)]
        return torch.cat(parts) if parts else shards[0][:0].cpu()

    def vectors(self) -> np.ndarray:
        """Host copy of the rows in insertion order, as float32."""
        return self._rows(self._buf).float().numpy()

    def state_dict(self) -> dict:
        # FlatIndex's payload ("vectors" in insertion order), so a sharded
        # save also loads as a one-device index; the kind routes
        # VectorStore.load_index back to a sharded one
        state = {
            "kind": "sharded_flat",
            "dim": self.dim,
            "metric": self.metric,
            "dtype": self.dtype_name,
            "vectors": codec.to_host(self._rows(self._buf)),
        }
        if self.ndeleted:
            state["dead"] = self._rows(self._dead).numpy()
        return state

    @classmethod
    def from_state_dict(
        cls, state: dict, mesh: Optional[Mesh] = None, **kwargs
    ) -> "ShardedFlatIndex":
        """Rebuild from a saved state of either package. ``mesh`` defaults
        to every visible card on a "db" axis (none visible raises)."""
        def item(v):
            v = np.asarray(v)
            return v.item() if v.ndim == 0 else v

        if mesh is None:
            mesh = make_mesh()
        vectors = np.asarray(state["vectors"])
        idx = cls(dim=int(item(state["dim"])), mesh=mesh, metric=str(item(state["metric"])),
                  dtype=str(item(state["dtype"])), **kwargs)
        if idx.dtype == torch.bfloat16 and vectors.dtype != np.float32:
            vectors = codec.from_host(vectors, torch.bfloat16)  # uint16 bits, exactly
        if len(vectors):
            idx.add(vectors)
        if "dead" in state:
            idx.remove_ids(np.nonzero(np.asarray(state["dead"], bool))[0])
        return idx
