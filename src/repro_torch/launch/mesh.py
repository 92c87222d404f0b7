"""Device meshes of the port (``src/repro/launch/mesh.py``).

A :class:`Mesh` names the axes of an array of ``torch.device``s, as a jax
mesh names the axes of its devices. Building one outside a
``torch.distributed`` world touches no device state: a CUDA device is
only a name until something is placed on it.

Topology of the production mesh:
  single pod : (data=16, model=16)            = 256 cards
  multi-pod  : (pod=2, data=16, model=16)     = 512 cards

`pod` is the slow inter-pod axis (data parallelism and the compressed
gradient exchange), `data` intra-pod data parallelism, `model` tensor
parallelism.

The port is multi-controller: one process a mesh position. A mesh built
inside an initialised ``torch.distributed`` world is a RANK mesh: its
positions are the world's ranks in row-major order (the world's size
must equal the mesh's), each rank keeps its own device (``devices[rank]``
when given, e.g. ``["cpu"] * n`` on the CPU; else ``cuda:rank`` modulo
the cards present: ``cuda:0`` for every rank on a one-card machine), and
the process group of every slice of every set of axes is built once,
collectively, at construction (:meth:`Mesh.group`). Training and serving
run over such meshes (``launch/train.py``, ``launch/serve.py``,
``runtime/sharding.py``).

Outside a world a mesh is LOGICAL: every position may name one device
(``devices=["cpu"] * n``), and placement there keeps whole leaves on it;
one process cannot drive a mesh whose positions name several devices
(``runtime/sharding.py::mesh_device`` raises).
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """`devices`: an object array of ``torch.device``s whose shape gives
    the axis sizes; `axis_names`: one name per axis. A rank mesh also
    has `ranks` (the rank at each position), `rank` (this process's) and
    its process groups; a logical one has ``ranks is None``."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        arr = np.asarray(devices, dtype=object)
        devs = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            devs[idx] = torch.device(arr[idx])
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-D device array for axes "
                             f"{axis_names}")
        self.devices = devs
        self.axis_names = axis_names
        self.ranks = None if ranks is None else np.asarray(ranks)
        self.rank = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.ranks is not None:
            self._build_groups()

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def is_rank_mesh(self) -> bool:
        return self.ranks is not None

    @property
    def device_set(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the mesh, in first-seen order (a
        logical mesh may name one device many times). A rank mesh: this
        rank's device."""
        if self.is_rank_mesh:
            return (self.local_device,)
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return tuple(seen)

    # -- rank meshes ---------------------------------------------------------
    @property
    def coords(self) -> Dict[str, int]:
        """{axis: this rank's coordinate} on a rank mesh."""
        pos = np.argwhere(self.ranks == self.rank)[0]
        return dict(zip(self.axis_names, (int(c) for c in pos)))

    @property
    def local_device(self) -> torch.device:
        pos = tuple(np.argwhere(self.ranks == self.rank)[0])
        return self.devices[pos]

    def _build_groups(self):
        """Every slice of every non-empty set of axes as a process group:
        all ranks create every group in one order (``new_group`` is
        collective over the world)."""
        import torch.distributed as dist
        from ..runtime.dist import LANES, RankGroup
        self.rank = dist.get_rank()
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                moved = np.moveaxis(
                    self.ranks, [names.index(a) for a in axes],
                    list(range(len(names) - k, len(names))))
                n = int(np.prod([self.shape[a] for a in axes]))
                slices = [tuple(int(r) for r in s)
                          for s in moved.reshape(-1, n)]
                mine = None
                for s in slices:
                    lanes = tuple(dist.new_group(list(s))
                                  for _ in range(LANES)) if n > 1 else ()
                    if self.rank in s:
                        mine = RankGroup(lanes, s, s.index(self.rank))
                self._groups[axes] = mine

    def group(self, axes) -> "RankGroup":
        """This rank's slice of the mesh along `axes` (a name or a
        sequence of names): the ranks that share every other coordinate,
        in row-major order of `axes` as the mesh orders them."""
        if not self.is_rank_mesh:
            raise ValueError("process groups belong to a rank mesh (a mesh "
                             "built inside a torch.distributed world)")
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(set(axes)):
            raise ValueError(f"axes {axes} not all in {self.axis_names}")
        if not key:
            from ..runtime.dist import RankGroup
            return RankGroup((), (self.rank,), 0)
        return self._groups[key]


def _cuda_devices(n: int):
    return [torch.device("cuda", i) for i in range(n)]


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production topology over cuda:0..n-1; raises RuntimeError
    when fewer cards are present than the mesh needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} CUDA devices")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the first prod(shape) of `devices` (default cuda:0..n-1;
    a list that names one device n times gives a logical mesh on it).

    Inside an initialised ``torch.distributed`` world the mesh is a rank
    mesh over the whole world (its size must be prod(shape)): rank r sits
    at row-major position r on ``devices[r]``, or on ``cuda:r`` modulo
    the cards present without `devices`."""
    n = int(np.prod(shape))
    world = _world()
    if world is not None:
        if world != n:
            raise ValueError(f"a world of {world} processes for a mesh "
                             f"{tuple(shape)} of {n} positions")
        if devices is None:
            count = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if not count:
                raise RuntimeError(
                    "no CUDA device for a rank mesh: pass devices (e.g. "
                    "['cpu'] * n) to run the ranks on the CPU")
            devices = [torch.device("cuda", r % count) for r in range(n)]
    devices = list(_cuda_devices(n) if devices is None else devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices for mesh {tuple(shape)}, "
                         f"got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    ranks = None if world is None else np.arange(n).reshape(tuple(shape))
    return Mesh(arr.reshape(tuple(shape)), axes, ranks=ranks)


def parse_mesh(text: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """'pod=2,data=1,model=2' -> ((2, 1, 2), ('pod', 'data', 'model'));
    the reference's '2x2' form names the last axes of (pod, data,
    model)."""
    if "=" in text:
        pairs = [p.split("=") for p in text.split(",") if p]
        return (tuple(int(v) for _, v in pairs),
                tuple(k.strip() for k, _ in pairs))
    dims = tuple(int(x) for x in text.split("x"))
    return dims, ("pod", "data", "model")[-len(dims):]
