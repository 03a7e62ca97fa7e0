"""The agent mesh: virtual PEMs as slots of a (kelvin, agents) grid.

A port of the JAX package's ``parallel/mesh.py``. Each slot of the mesh
is a "virtual PEM" holding a row shard of every window; the ``agents``
axis is the data-parallel axis whose per-shard states merge first, and
``kelvin`` (size > 1 for a 2D mesh) is the second merge tier, mirroring
the PEM -> Kelvin -> broker reduction.

The mesh is a plain object, not a compiled sharding: ``devices`` is a
numpy object array of ``torch.device`` shaped ``(n_kelvin, n_agents)``.
Slots may repeat one device: ``devices=[torch.device("cpu")] * 8`` is
eight virtual PEMs on the CPU, ``[cuda:0] * 4`` four on one card. A
window's planes split into the mesh's row shards with
``row_shards``: contiguous ranges, kelvin-major (the order the JAX
package's ``P((kelvin, agents))`` gives), each a view of the plane when
the slot's device is the plane's. Shards may be uneven (a degraded
3-slot mesh over a 2^k-row window), so nothing pads a window to a
multiple of the slot count.

This module imports nothing of ``exec/``, so the distributed planner can
read ``AGENTS``/``KELVIN`` from here without a cycle.
"""

from __future__ import annotations

import math

import numpy as np
import torch

AGENTS = "agents"
KELVIN = "kelvin"

__all__ = ["AGENTS", "KELVIN", "AgentMesh", "agent_mesh", "pad_to_multiple",
           "row_shards", "shard_bounds"]


class AgentMesh:
    """A ``(kelvin, agents)`` grid of slot devices. ``axis_names`` and
    ``devices`` (with ``.shape``, ``.size`` and ``.flatten()``) read as
    the JAX ``Mesh``'s do, which the distributed planner's ``stitch``
    reads duck-typed."""

    axis_names = (KELVIN, AGENTS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be 2D, got {devices.shape}")
        self.devices = devices

    @property
    def slots(self) -> list:
        """The slot devices in shard order (kelvin-major)."""
        return list(self.devices.flatten())

    def distinct_devices(self) -> list:
        """Each device the mesh's slots sit on, once, in slot order."""
        out: list = []
        for d in self.slots:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        n_kelvin, n_agents = self.devices.shape
        return (f"AgentMesh({n_kelvin}x{n_agents}, "
                f"devices={[str(d) for d in self.distinct_devices()]})")


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def agent_mesh(n_agents: int | None = None, n_kelvin: int = 1,
               devices=None) -> AgentMesh:
    """Build a ``(kelvin, agents)`` mesh over ``devices`` (a list, which
    may repeat a device for virtual PEMs). Without ``devices``, every
    visible CUDA card; raises when there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices= (for example "
                "[torch.device('cpu')] * 8) for a mesh of virtual PEMs"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_normalize(d) for d in devices]
    if n_agents is None:
        n_agents = len(devices) // n_kelvin
    need = n_agents * n_kelvin
    if n_agents < 1 or need > len(devices):
        raise ValueError(
            f"mesh {n_agents}x{n_kelvin} needs {max(need, n_kelvin)} devices, "
            f"have {len(devices)}"
        )
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return AgentMesh(arr.reshape(n_kelvin, n_agents))


def shard_bounds(n: int, n_shards: int) -> list:
    """The ``[start, stop)`` row range of each of ``n_shards`` contiguous
    shards of ``n`` rows, as ``torch.tensor_split`` cuts them (the first
    ``n % n_shards`` shards one row longer)."""
    base, extra = divmod(n, n_shards)
    out, start = [], 0
    for i in range(n_shards):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def row_shards(plane: torch.Tensor, mesh: AgentMesh) -> list:
    """Split a ``[n, ...]`` plane into the mesh's row shards, one per slot
    in shard order, each on its slot's device: a view of ``plane`` where
    the slot's device is the plane's, else a copy there."""
    slots = mesh.slots
    parts = torch.tensor_split(plane, len(slots))
    return [p if p.device == d else p.to(d) for p, d in zip(parts, slots)]


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m)) * m if n else m
