"""Device mesh of the parallel layer (counterpart of
``mpqe_tpu/parallel/mesh.py``).

A :class:`Mesh` is a 2-D ``(data, model)`` grid of explicit
``torch.device`` s with axis names:

  data   — query-batch and destination-node-block partitioning
  model  — relation blocks

A device list may repeat one device: ``[cuda:0] * 4`` is a ring of four
parts on one card, the port's counterpart of the forced host device count
that the reference's tests run on (each part keeps its own buffers and
receives its neighbours' blocks only by copies).  Across cards the same
code moves tensors with ``.to(device)``.

The collectives that the reference takes from ``lax`` inside
``shard_map`` are plain functions here, over per-part lists of tensors
(part p's tensor on the mesh's device p along the axis), and autograd
flows through them: :func:`all_gather`, :func:`ppermute` (a ring shift)
and :func:`psum`.

The reference's ``replicated`` and ``sharded`` (``NamedSharding``) have no
counterpart: the port has one controller, which places each part's
tensors on its device itself, and parameters stay where they are
(replicated by ``.to(device)`` inside the layers).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A ``(data, model)`` grid of ``torch.device`` s.  ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str, index: int = 0) -> List[torch.device]:
        """The devices along ``axis``, at position ``index`` of the other
        axis: part p of a layer over ``axis`` runs on the p-th."""
        a = self.axis_names.index(axis)
        return list(np.take(self.devices, index, axis=1 - a))


def default_devices() -> List[torch.device]:
    """Every visible card; ``RuntimeError`` without one (the CPU is a
    device a caller names)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass devices=[torch.device("
                           "'cpu'), ...] to run the mesh on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def cli_mesh(shape: Tuple[int, int], device: torch.device,
             flag: str) -> Mesh:
    """The mesh of a CLI flag (``--shards``, ``--mesh``) on ``device``'s
    kind: on the card one distinct card per part, ``SystemExit`` naming
    ``flag`` when there are fewer (a card is never repeated silently);
    under the CPU every part on the CPU (the port's counterpart of the
    reference's forced host device count)."""
    n = shape[0] * shape[1]
    if device.type == "cpu":
        return make_mesh(shape, devices=[device] * n)
    have = torch.cuda.device_count()
    if have < n:
        raise SystemExit(f"{flag} needs that many devices, have {have} "
                         "(--device cpu puts the parts on the CPU)")
    return make_mesh(shape, devices=[torch.device("cuda", i)
                                     for i in range(n)])


def _device(d) -> torch.device:
    """``torch.device(d)``, a CUDA device with its index filled in (tensors
    report theirs, and the parts are grouped by device)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 2-D (data, model) mesh; defaults to all devices on the data axis.

    ``shape=(-1, m)`` puts m devices on the model axis and the rest on
    data.  ``ValueError`` when the shape's product is not the number of
    devices.  A device may appear more than once."""
    devices = [_device(d) for d in (
        devices if devices is not None else default_devices())]
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    d, m = shape
    if d == -1:
        d = n // m
    if m == -1:
        m = n // d
    if d * m != n:
        raise ValueError(f"mesh shape {d}x{m} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(d, m), axis_names)


def data_axis(mesh: Mesh) -> str:
    return mesh.axis_names[0]


def model_axis(mesh: Mesh) -> str:
    return mesh.axis_names[1]


# ----------------------------------------------------------------------
# Collectives over per-part lists (``parts[p]`` on ``devices[p]``)
# ----------------------------------------------------------------------
def scatter_blocks(x: torch.Tensor,
                   devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Split ``x``'s leading axis into ``len(devices)`` equal blocks, block
    p on ``devices[p]`` (the ``P(axis, ...)`` in_spec of ``shard_map``)."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split into "
                         f"{n} parts")
    return [b.to(dev) for b, dev in zip(x.chunk(n), devices)]


def gather_blocks(parts: Sequence[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """Concatenate the parts on ``device`` (the ``P(axis, ...)``
    out_spec)."""
    return torch.cat([t.to(device) for t in parts])


def all_gather(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.all_gather(..., axis=0, tiled=True)``: every part receives the
    concatenation of all parts, on its own device."""
    return [torch.cat([t.to(dev) for t in parts]) for dev in devices]


def ppermute(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
             shift: int = 1) -> List[torch.Tensor]:
    """``lax.ppermute`` over the ring ``p -> (p + shift) % P``: part p
    receives part ``(p - shift) % P``'s tensor."""
    n = len(parts)
    return [parts[(p - shift) % n].to(devices[p]) for p in range(n)]


def psum(parts: Sequence[torch.Tensor],
         devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.psum``: every part receives the sum of all parts, added in
    part order on its own device."""
    out = []
    for dev in devices:
        acc = parts[0].to(dev)
        for t in parts[1:]:
            acc = acc + t.to(dev)
        out.append(acc)
    return out
