"""Device meshes of the port (``src/repro/launch/mesh.py``).

A :class:`Mesh` names the axes of an array of ``torch.device``s, as a jax
mesh names the axes of its devices. Building one touches no device
state: a CUDA device is only a name until something is placed on it.

Topology of the production mesh:
  single pod : (data=16, model=16)            = 256 cards
  multi-pod  : (pod=2, data=16, model=16)     = 512 cards

`pod` is the slow inter-pod axis (data parallelism and the compressed
gradient exchange), `data` intra-pod data parallelism, `model` tensor
parallelism. The port places leaves on a mesh that spans one device;
placement over several cards comes with training (ROADMAP Queue 1 item
5).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """`devices`: an object array of ``torch.device``s whose shape gives
    the axis sizes; `axis_names`: one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
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

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_set(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the mesh, in first-seen order (a
        logical mesh may name one device many times)."""
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return tuple(seen)


def _cuda_devices(n: int):
    return [torch.device("cuda", i) for i in range(n)]


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
    a list that names one device n times gives a logical mesh on it)."""
    n = int(np.prod(shape))
    devices = list(_cuda_devices(n) if devices is None else devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices for mesh {tuple(shape)}, "
                         f"got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(arr.reshape(tuple(shape)), axes)
