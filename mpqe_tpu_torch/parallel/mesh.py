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

A mesh made by :func:`make_mesh` lives in one process, which places each
part's tensors on its device itself; parameters stay where they are
(replicated by ``.to(device)`` inside the layers).  A mesh made by
``parallel/multihost.py global_mesh`` spans the processes of a
``torch.distributed`` group, as JAX's global device list does: each
entry of the grid also names its process (``Mesh.procs``), each process
holds and computes only its own parts, and :meth:`Mesh.axis_devices`
returns an :class:`AxisDevices`.  Given one, the collectives take this
process's parts (a per-part list holds ``None`` for another process's
part) and exchange the others through ``multihost.exchange`` (gloo for
CPU tensors, ``parallel/ipc.py`` on the card), each a
``torch.autograd.Function`` whose backward is its ``shard_map``
transpose.  Every process computes the same whole loss from the parts'
outputs, so:

* a replicated parameter entering the parts (:func:`enter_parts`):
  identity; backward, the local parts' gradients summed over the
  processes once, in process order;
* a replicated ``x`` split into blocks (:func:`scatter_blocks`): this
  process's blocks; backward, the blocks' cotangents all-gathered, so
  that every process's gradient of ``x`` is whole;
* the parts' outputs back to the replicated layout
  (:func:`gather_blocks`): all-gathered; backward, this process's slices,
  with no sum (every process holds the whole cotangent);
* :func:`ppermute`: send to ``p + shift``; backward, to ``p - shift``;
* :func:`all_gather`: all-gather; backward, each part's block of every
  receiver's cotangent, added in receiver order (a reduce-scatter);
* :func:`psum`: all-gather, then add in part order (two processes equal
  one bit for bit); backward, the same.

A process may hold parts on several cards (JAX's multi-host shape: each
host a process over its chips).  Each crossing is one autograd node over
all of the process's parts, so it exchanges once, from the process's
first card (:func:`_here`), each part's tensor then moving to its own
card.  The autograd engine runs a CUDA node on its card's own worker
thread, so two crossings whose gradients arrive on different cards could
run their backward exchanges in different orders in different
processes.  Inside :func:`ordered_crossings` (the halo loss enters it)
each crossing is tied to the previous one by an order token (a 0-d
tensor, an edge of the graph and no data): a crossing's backward starts only once the
next crossing's backward has run, so every process runs its backward's
exchanges in the reverse of its forward's order, whichever thread runs
them (``multihost.exchange``'s tag turns any other order into a
``RuntimeError``).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class AxisDevices(list):
    """The devices along one axis of a mesh that spans processes: a list
    of ``torch.device`` s (another process's entries name its devices),
    with ``procs`` (each part's process), ``rank`` (this process) and
    ``world`` (the processes of the mesh)."""

    def __init__(self, devices, procs, rank: int, world: int):
        super().__init__(devices)
        self.procs = [int(r) for r in procs]
        self.rank, self.world = rank, world

    @property
    def local(self) -> List[int]:
        """The parts this process holds, ascending."""
        return [p for p, r in enumerate(self.procs) if r == self.rank]

    @property
    def spans(self) -> bool:
        """Whether the axis's parts lie in more than one process."""
        return len(set(self.procs)) > 1


class Mesh:
    """A ``(data, model)`` grid of ``torch.device`` s.  ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does.
    ``procs`` (the same shape, or None when every part is in this
    process) gives each entry's process; ``rank`` is this process's."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str],
                 procs: Optional[np.ndarray] = None, rank: int = 0):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.procs = (None if procs is None
                      else np.asarray(procs).reshape(devices.shape))
        self.rank = rank

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        return self.procs is not None and len(set(self.procs.flat)) > 1

    def axis_devices(self, axis: str, index: Optional[int] = None
                     ) -> List[torch.device]:
        """The devices along ``axis``, at position ``index`` of the other
        axis (by default the first position at which this process holds
        a part): part p of a layer over ``axis`` runs on the p-th.  An
        :class:`AxisDevices` when the mesh spans processes."""
        a = self.axis_names.index(axis)
        if index is None:
            index = 0
            if self.procs is not None:
                index = next(j for j in range(self.devices.shape[1 - a])
                             if (np.take(self.procs, j, axis=1 - a)
                                 == self.rank).any())
        devs = list(np.take(self.devices, index, axis=1 - a))
        if not self.spans_processes:
            return devs
        return AxisDevices(devs, np.take(self.procs, index, axis=1 - a),
                           self.rank, len(set(self.procs.flat)))

    def local_parts(self, axis: str, index: Optional[int] = None
                    ) -> List[Tuple[int, torch.device]]:
        """``(part, device)`` of each part along ``axis`` (at ``index`` as
        in :meth:`axis_devices`) that this process holds."""
        devs = self.axis_devices(axis, index)
        return [(p, devs[p]) for p in getattr(devs, "local",
                                              range(len(devs)))]

    def local_devices(self) -> List[torch.device]:
        """This process's entries of the grid, in row-major order."""
        if self.procs is None:
            return list(self.devices.flat)
        return [d for d, r in zip(self.devices.flat, self.procs.flat)
                if r == self.rank]


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
    p on ``devices[p]`` (the ``P(axis, ...)`` in_spec of ``shard_map``).
    Across processes: this process's blocks, ``None`` for the others."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split into "
                         f"{n} parts")
    mode = _mode(devices)
    if mode == "remote":
        return [None] * n
    if mode == "spans":
        (x,) = _tie([x])
        return _full(devices, _mark(_Scatter.apply(x, devices)))
    return [b.to(dev) for b, dev in zip(x.chunk(n), devices)]


def gather_blocks(parts: Sequence[torch.Tensor], device: torch.device,
                  devices: Optional[Sequence[torch.device]] = None
                  ) -> torch.Tensor:
    """Concatenate the parts on ``device`` (the ``P(axis, ...)``
    out_spec).  ``devices``, the parts' :class:`AxisDevices` of a mesh
    that spans processes: every process receives the whole result."""
    if isinstance(devices, AxisDevices):
        return _mark(_Gather.apply(torch.device(device), devices,
                                   *_tie([parts[p] for p in devices.local])))
    return torch.cat([t.to(device) for t in parts])


def all_gather(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.all_gather(..., axis=0, tiled=True)``: every part receives the
    concatenation of all parts, on its own device."""
    mode = _mode(devices)
    if mode == "remote":
        return [None] * len(devices)
    if mode == "spans":
        return _full(devices, _mark(_AllGather.apply(
            devices, *_tie([parts[p] for p in devices.local]))))
    return [torch.cat([t.to(dev) for t in parts]) for dev in devices]


def ppermute(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
             shift: int = 1) -> List[torch.Tensor]:
    """``lax.ppermute`` over the ring ``p -> (p + shift) % P``: part p
    receives part ``(p - shift) % P``'s tensor."""
    n = len(parts)
    mode = _mode(devices)
    if mode == "remote":
        return [None] * n
    if mode == "spans":
        return _full(devices, _mark(_Ppermute.apply(
            devices, shift, *_tie([parts[p] for p in devices.local]))))
    return [parts[(p - shift) % n].to(devices[p]) for p in range(n)]


def psum(parts: Sequence[torch.Tensor],
         devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``lax.psum``: every part receives the sum of all parts, added in
    part order on its own device."""
    mode = _mode(devices)
    if mode == "remote":
        return [None] * len(devices)
    if mode == "spans":
        return _full(devices, _mark(_Psum.apply(
            devices, *_tie([parts[p] for p in devices.local]))))
    return _sum_in_order(parts, devices)


def enter_parts(tensors: Sequence[torch.Tensor],
                devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Replicated tensors (a layer's parameters) as the parts of
    ``devices`` read them: themselves, unless the parts span processes;
    then the same values, whose gradients (each process's local parts'
    sum) are summed over the processes in process order."""
    if _mode(devices) != "spans":
        return list(tensors)
    return list(_mark(_Enter.apply(devices, *_tie(list(tensors)))))


def _sum_in_order(parts, devices) -> List[torch.Tensor]:
    out = []
    for dev in devices:
        acc = parts[0].to(dev)
        for t in parts[1:]:
            acc = acc + t.to(dev)
        out.append(acc)
    return out


# ----------------------------------------------------------------------
# Across processes
# ----------------------------------------------------------------------
def _mode(devices) -> str:
    """``"local"`` (every part in this process, the one-process code),
    ``"remote"`` (every part in another process) or ``"spans"``."""
    if not isinstance(devices, AxisDevices):
        return "local"
    if devices.spans:
        return "spans"
    return "local" if devices.procs[0] == devices.rank else "remote"


def _full(devices: AxisDevices, local: Sequence) -> list:
    """A per-part list: ``local`` (this process's parts, ascending) at
    their places, ``None`` elsewhere."""
    out = [None] * len(devices)
    for p, t in zip(devices.local, local):
        out[p] = t
    return out


def _here(devices: AxisDevices) -> torch.device:
    """The device a crossing exchanges from: this process's first part's
    (its other parts' tensors move there for the exchange, and what each
    part receives moves on to that part's own device)."""
    return devices[devices.local[0]]


# the crossing-order token: {"on": inside ordered_crossings, "token": the
# last crossing's}
_ORDER = {"on": False, "token": None}


@contextmanager
def ordered_crossings():
    """Within: each crossing across processes that autograd records is
    tied to the previous one by an order token, so that the backward runs
    their exchanges one after another in the reverse of the forward's
    order (see the module docstring).  The token chain starts afresh on
    entry and is dropped on exit."""
    saved = dict(_ORDER)
    _ORDER.update(on=True, token=None)
    try:
        yield
    finally:
        _ORDER.update(saved)


def _ordering() -> bool:
    return _ORDER["on"] and torch.is_grad_enabled()


class _Tie(torch.autograd.Function):
    """``apply(token, *tensors)`` -> the tensors unchanged; backward, their
    gradients and none for the token: the edge that makes the previous
    crossing's backward wait for this crossing's."""

    @staticmethod
    def forward(ctx, token, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _Mark(torch.autograd.Function):
    """``apply(t)`` -> a new order token (a 0-d CPU zero) that depends on
    a crossing's output ``t``."""

    @staticmethod
    def forward(ctx, t):
        return torch.zeros(())

    @staticmethod
    def backward(ctx, g):
        return None


def _tie(tensors: list) -> list:
    """A crossing's inputs, tied to the previous crossing's token while
    :func:`ordered_crossings` is on."""
    token = _ORDER["token"]
    if not _ordering() or token is None or not any(
            t.requires_grad for t in tensors):
        return list(tensors)
    return list(_Tie.apply(token, *tensors))


def _mark(out):
    """A crossing's output (a tensor or a tuple), its token taken while
    :func:`ordered_crossings` is on."""
    if _ordering():
        first = out if isinstance(out, torch.Tensor) else next(
            (t for t in out if t is not None), None)
        if first is not None and first.requires_grad:
            _ORDER["token"] = _Mark.apply(first)
    return out


def _exchange_parts(devices: AxisDevices, mine: Sequence[torch.Tensor],
                    owners: Sequence[int], device, tag: str) -> list:
    """Every process's tensors for the parts ``owners`` lists (each part
    once, ascending, with its process), this process's ``mine`` among
    them: a per-part list of the parts' tensors on ``device`` (``None``
    for parts ``owners`` leaves out)."""
    from mpqe_tpu_torch.parallel import multihost

    got = multihost.exchange([t.to(device) for t in mine], device, tag)
    out = [None] * len(devices)
    taken = [0] * devices.world
    for p in owners:
        r = devices.procs[p]
        out[p] = got[r][taken[r]]
        taken[r] += 1
    return out


def _saved(ctx, devices, outs) -> tuple:
    """Keep on ``ctx`` what :func:`_cotangents` needs of ``outs`` (this
    process's outputs); returns them."""
    ctx.devices = devices
    ctx.like = [torch.empty_like(t, device="meta") for t in outs]
    return tuple(outs)


def _cotangents(ctx, gs) -> list:
    """The cotangents of this process's outputs, zeros where autograd
    gives none (an output the loss does not reach)."""
    devs = ctx.devices
    return [g if g is not None else torch.zeros(
        t.shape, dtype=t.dtype, device=devs[p])
        for g, t, p in zip(gs, ctx.like, devs.local)]


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.device = x.device
        blocks = x.chunk(len(devices))
        return _saved(ctx, devices, [blocks[p].to(devices[p], copy=True)
                                     for p in devices.local])

    @staticmethod
    def backward(ctx, *gs):
        devs = ctx.devices
        every = _exchange_parts(devs, _cotangents(ctx, gs), range(len(devs)),
                                _here(devs), "scatter_blocks.T")
        return torch.cat([t.to(ctx.device) for t in every]), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, devices, *local):
        here = _here(devices) if devices.local else device
        every = _exchange_parts(devices, local, range(len(devices)), here,
                                "gather_blocks")
        rows = [t.shape[0] for t in every]
        ctx.devices = devices
        ctx.spans = [(sum(rows[:p]), rows[p]) for p in devices.local]
        return torch.cat([t.to(device) for t in every])

    @staticmethod
    def backward(ctx, g):
        devs = ctx.devices
        return (None, None, *(g[a:a + n].to(devs[p]) for (a, n), p in
                              zip(ctx.spans, devs.local)))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *local):
        every = _exchange_parts(devices, local, range(len(devices)),
                                _here(devices), "all_gather")
        ctx.rows = [t.shape[0] for t in every]
        return _saved(ctx, devices, [torch.cat([t.to(devices[p])
                                                for t in every])
                                     for p in devices.local])

    @staticmethod
    def backward(ctx, *gs):
        devs, rows = ctx.devices, ctx.rows
        every = _exchange_parts(devs, _cotangents(ctx, gs), range(len(devs)),
                                _here(devs), "all_gather.T")
        out = []
        for p in devs.local:
            a = sum(rows[:p])
            acc = every[0][a:a + rows[p]].to(devs[p])
            for g in every[1:]:
                acc = acc + g[a:a + rows[p]].to(devs[p])
            out.append(acc)
        return (None, *out)


def _shift(devices: AxisDevices, local: Sequence[torch.Tensor], shift: int,
           tag: str) -> list:
    """This process's parts of ``ppermute``: part p receives part ``(p -
    shift) % n``'s tensor; the senders whose receiver lies in another
    process cross by one exchange."""
    n = len(devices)
    procs = devices.procs
    mine = dict(zip(devices.local, local))
    crossing = [q for q in range(n) if procs[(q + shift) % n] != procs[q]]
    sent = _exchange_parts(
        devices, [mine[q] for q in crossing if q in mine], crossing,
        _here(devices), tag)
    out = []
    for p in devices.local:
        q = (p - shift) % n
        out.append((mine[q] if q in mine else sent[q]).to(devices[p]))
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, shift, *local):
        ctx.shift = shift
        return _saved(ctx, devices, _shift(devices, local, shift,
                                           "ppermute"))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_shift(ctx.devices, _cotangents(ctx, gs),
                                    -ctx.shift, "ppermute.T"))


def _psum_local(devices: AxisDevices, local, tag: str) -> list:
    every = _exchange_parts(devices, local, range(len(devices)),
                            _here(devices), tag)
    return _sum_in_order(every, [devices[p] for p in devices.local])


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *local):
        return _saved(ctx, devices, _psum_local(devices, local, "psum"))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_psum_local(ctx.devices, _cotangents(ctx, gs),
                                   "psum.T"))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *tensors):
        ctx.devices = devices
        ctx.like = [torch.empty_like(t, device="meta") for t in tensors]
        ctx.device = [t.device for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *gs):
        from mpqe_tpu_torch.parallel import multihost

        here = _here(ctx.devices)
        flat = torch.cat([
            (g if g is not None else torch.zeros(
                t.shape, dtype=t.dtype, device=here)).to(here).reshape(-1)
            for g, t in zip(gs, ctx.like)])
        got = multihost.exchange([flat], here, "enter_parts.T")
        total = got[0][0]
        for r in range(1, len(got)):
            total = total + got[r][0]
        out, a = [], 0
        for t, dev in zip(ctx.like, ctx.device):
            out.append(total[a:a + t.numel()].view(t.shape).to(dev))
            a += t.numel()
        return (None, *out)
