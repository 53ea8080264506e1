"""Device mesh construction.

Counterpart of ``rag_faiss_embedding_tpu/core/mesh.py``. JAX's sharded
indexes have one controller: one process owns every device of a
``jax.sharding.Mesh`` and calls ``search`` from one thread. The port keeps
that model: a ``Mesh`` is a named grid of ``torch.device``s owned by this
process, and the sharded classes (``parallel/sharded.py``,
``parallel/sharded_ivf.py``) hold one tensor per shard on its device and
merge the shards' top-k on the first one. No ``torch.distributed`` process
group is involved, so ``VectorStore``, ``QueryEngine`` and the server call a
sharded index as they call a one-card index.

A device may repeat in the grid, so N shards can live on one card (or on
the CPU, as the tests run them).

Axis conventions, as in the JAX package:
  "data"  — query data-parallel axis
  "db"    — vector-database row axis (shard-local top-k, then a merge)
  "model" — tensor-parallel axis for encoder training
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "Placement", "make_mesh", "single_device_mesh", "sharding",
           "replicated"]


def _visible_cards() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass devices=[torch.device('cpu')] * n "
            "to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A grid of devices with named axes (the ``jax.sharding.Mesh`` analog).

    ``devices`` is a numpy object array of ``torch.device`` whose shape is
    the axis sizes; ``shape`` maps axis name -> size in axis order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(given[pos])
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        if len(names) != grid.ndim or len(set(names)) != len(names):
            raise ValueError(f"axis names {names} do not name the {grid.ndim} axes "
                             f"of a {grid.shape} device grid")
        self.devices = grid
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def axis_sizes(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    @property
    def local_mesh(self) -> "Mesh":
        """The devices this process owns: all of them (one controller)."""
        return self

    def update(self, devices=None, axis_names=None, axis_types=None) -> "Mesh":
        """A copy with other devices or axis names. ``axis_types`` is taken
        for the JAX signature: the port has one kind of axis."""
        if axis_types is not None:
            raise ValueError("the port's mesh axes have no types")
        return Mesh(self.devices if devices is None else devices,
                    self.axis_names if axis_names is None else axis_names)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, every other axis at position 0."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return [grid[(i,) + (0,) * (grid.ndim - 1)] for i in range(grid.shape[0])]

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.flat]
        return f"Mesh({self.shape}, devices={devs})"


class Placement:
    """Where a tensor's parts live on a mesh (the ``NamedSharding`` analog):
    dim ``i`` is split evenly over the mesh axis ``spec[i]`` names (``None``
    or a missing entry: not split), and every axis the spec does not name
    holds a copy, as ``NamedSharding(mesh, P(*spec))`` places a JAX array."""

    def __init__(self, mesh: Mesh, spec: tuple = ()):
        for name in spec:
            if name is not None and name not in mesh.axis_names:
                raise ValueError(f"spec names axis {name!r}, mesh has {mesh.axis_names}")
        self.mesh = mesh
        self.spec = tuple(spec)

    def part(self, x: torch.Tensor, pos: tuple) -> torch.Tensor:
        """The part of ``x`` that mesh position ``pos`` holds, on its device."""
        mesh = self.mesh
        part = x
        for dim, name in enumerate(self.spec):
            if name is None:
                continue
            n = mesh.shape[name]
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                                 f"over axis {name}={n}")
            step = x.shape[dim] // n
            part = part.narrow(dim, pos[mesh.axis_names.index(name)] * step, step)
        return part.to(mesh.devices[pos])

    def put_along(self, x: torch.Tensor, axis: str) -> list:
        """``x``'s parts at the positions along ``axis`` (every other axis
        at position 0), each on its position's device: the per-shard
        tensors the sharded indexes keep. Where positions share a device
        the parts are views of one copy."""
        mesh = self.mesh
        a = mesh.axis_names.index(axis)
        return [self.part(x, tuple(i if j == a else 0 for j in range(len(mesh.axis_names))))
                for i in range(mesh.shape[axis])]


def make_mesh(
    axis_shapes: Optional[dict] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over ``devices`` (default: every visible CUDA card; none
    raises). ``axis_shapes`` maps axis name -> size; a single ``-1`` entry
    is inferred. Default: all devices on one ``"db"`` axis. A device may
    appear more than once, to put several shards on one card."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else _visible_cards())]
    if axis_shapes is None:
        axis_shapes = {"db": len(devices)}
    names = tuple(axis_shapes)
    sizes = list(axis_shapes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if len(devices) % known:
            raise ValueError(f"{len(devices)} devices not divisible by {known}")
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Mesh(grid.reshape(sizes), names)


def single_device_mesh(axis: str = "db") -> Mesh:
    return make_mesh({axis: 1}, devices=_visible_cards()[:1])


def sharding(mesh: Mesh, *spec) -> Placement:
    return Placement(mesh, spec)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())
