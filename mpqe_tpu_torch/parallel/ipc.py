"""CUDA tensors between the processes of a group on one node: the card's
transport of ``multihost.exchange`` and of K8's ring across processes
(``ops/ring.py``).

Each process allocates its receive buffers once per key (shape, dtype,
counts) and exports them (``torch.multiprocessing.reductions
.reduce_tensor``); the handles are swapped over the group
(``all_gather_object``) and each peer maps the others' buffers
(``rebuild_cuda_tensor``; a handle is never opened in the process that
exported it).  A block then moves by one device copy into the peer's
buffer, on the sender's stream.  The API is the same whether the peer
sits on the same card or on another card of the host.

Ordering is by counters in IPC-mapped device memory, not by events: an
interprocess event orders a wait only against a record issued before the
wait, and nothing orders two processes' host calls.  A counter only
grows, so a wait enqueued before the peer's write still waits for it:

* the sender's stream writes the receiver's counter after its copy
  (``cuStreamWriteValue32``, which fences the copy's writes first);
* the receiver's stream waits until the counter reaches the exchange's
  number (``cuStreamWaitValue32``, ``GEQ``), in the front end, taking no
  SM from the peer's context (two processes on one card take turns on
  it);
* the receiver's ack, written into the sender's counters once it has
  read the buffer, is what the sender waits for before it writes that
  buffer again.

These are the TPU kernel's receive semaphores and ack tokens
(``mpqe_tpu/ops/pallas_ring.py``).  A stream's wait has no timeout of its
own: after enqueuing its part of an exchange each process meets the
others on the host (:func:`handshake`, a gloo ``all_gather`` under the
group's timeout), so a peer that never sends raises there, before any
synchronisation waits on a write that will not come.  The exported
buffers must outlive the peers' use of them: :func:`close` synchronises,
meets the peers, drops the mappings, meets them again and only then
frees.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

_WAIT_GEQ = 0x0  # CU_STREAM_WAIT_VALUE_GEQ: (int32)(*addr - value) >= 0
_WRITE_FENCED = 0x0  # CU_STREAM_WRITE_VALUE_DEFAULT: fences prior writes
_LIBCUDA = None
_CHANNELS: Dict[torch.device, "Channel"] = {}
_SHARED: List[torch.Tensor] = []  # exported buffers and peers' mappings


def _libcuda():
    """``libcuda``'s stream memory operations, argument types set."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        fns = {}
        for name in ("cuStreamWaitValue32", "cuStreamWriteValue32"):
            fn = getattr(lib, name + "_v2", None) or getattr(lib, name, None)
            if fn is None:
                raise RuntimeError(f"libcuda has no {name}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                           ctypes.c_uint32, ctypes.c_uint]
            fn.restype = ctypes.c_int
            fns[name] = fn
        _LIBCUDA = fns
    return _LIBCUDA


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def wait_value(stream: torch.cuda.Stream, addr: int, value: int) -> None:
    """``stream`` waits until the int32 at device address ``addr`` reaches
    ``value`` (signed, wrap-safe)."""
    _check(_libcuda()["cuStreamWaitValue32"](
        stream.cuda_stream, addr, value & 0xFFFFFFFF, _WAIT_GEQ),
        "cuStreamWaitValue32")


def write_value(stream: torch.cuda.Stream, addr: int, value: int) -> None:
    """``stream`` writes ``value`` to the int32 at ``addr`` once its earlier
    work (and its writes) are done."""
    _check(_libcuda()["cuStreamWriteValue32"](
        stream.cuda_stream, addr, value & 0xFFFFFFFF, _WRITE_FENCED),
        "cuStreamWriteValue32")


def _world():
    import torch.distributed as dist

    return dist.get_world_size(), dist.get_rank()


def share(t: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """Every process's ``t`` (collective: each process calls it with its
    own tensor of the same role): ``out[r]`` is process r's mapped into
    this process, ``None`` for this process's own."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor

    if t.device.type != "cuda":
        raise ValueError(f"ipc.share takes a CUDA tensor, got {t.device}")
    world, rank = _world()
    handles = [None] * world
    dist.all_gather_object(handles, reduce_tensor(t))
    out = [None if r == rank else fn(*args)
           for r, (fn, args) in enumerate(handles)]
    _SHARED.append(t)
    _SHARED.extend(m for m in out if m is not None)
    return out


class Counters:
    """An int32 array of this process's in device memory that peers write
    (collective to make), with every peer's mapped."""

    def __init__(self, device: torch.device, n: int):
        self.device = device
        self.mine = torch.zeros((n,), dtype=torch.int32, device=device)
        self.peers = share(self.mine)

    def write(self, stream, peer: int, i: int, value: int) -> None:
        """``stream`` sets peer's counter ``i`` to ``value`` (after its
        earlier work)."""
        write_value(stream, self.peers[peer].data_ptr() + 4 * i, value)

    def wait(self, stream, i: int, value: int) -> None:
        """``stream`` waits until this process's counter ``i`` reaches
        ``value``."""
        wait_value(stream, self.mine.data_ptr() + 4 * i, value)


def handshake(number: int, what: str) -> None:
    """Meet every process on the host (gloo, under the group's timeout)
    once this one has enqueued the writes of exchange ``number``;
    ``RuntimeError`` when a process is at another exchange."""
    import torch.distributed as dist

    world, _ = _world()
    mine = torch.tensor([number], dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    if len({int(t) for t in every}) != 1:
        raise RuntimeError(f"{what}: the processes are at exchanges "
                           f"{[int(t) for t in every]}")


class Channel:
    """This process's end of ``multihost.exchange`` on a CUDA device: a
    counter pair per peer (``flag``: the peer's copy has landed; ``ack``:
    the peer has read what this process wrote), receive buffers by key,
    and the running exchange number."""

    def __init__(self, device: torch.device):
        self.device = device
        self.world, self.rank = _world()
        self.counters = Counters(device, 2 * self.world)
        self.buffers: Dict[tuple, tuple] = {}
        self.number = 0
        self.last: Dict[tuple, int] = {}  # key -> its last exchange

    def _buffer(self, key: tuple, shape: tuple, dtype) -> tuple:
        if key not in self.buffers:  # collective: every process has the key
            mine = torch.zeros((self.world, *shape), dtype=dtype,
                               device=self.device)
            self.buffers[key] = (mine, share(mine))
        return self.buffers[key]

    def exchange(self, mine: Sequence[torch.Tensor], counts: Sequence[int],
                 shape: tuple, dtype) -> List[List[torch.Tensor]]:
        """``multihost.exchange``'s data: ``mine`` copied into row ``rank``
        of every peer's buffer, each peer's row of this process's buffer
        copied out once its flag says it landed, all on the current
        stream."""
        m = max(counts)
        key = (m, tuple(shape), dtype)
        buf, peers = self._buffer(key, (m, *shape), dtype)
        self.number += 1
        number, prev = self.number, self.last.get(key, 0)
        self.last[key] = number
        flag, ack = 0, self.world
        stream = torch.cuda.current_stream(self.device)
        out: List[List[torch.Tensor]] = [[] for _ in range(self.world)]
        others = [r for r in range(self.world) if r != self.rank]
        with torch.cuda.device(self.device):
            if mine:
                src = torch.stack(list(mine))
                for r in others:
                    # the peer has read what this process wrote there last
                    self.counters.wait(stream, ack + r, prev)
                    peers[r][self.rank, :len(mine)].copy_(src,
                                                          non_blocking=True)
            for r in others:
                self.counters.write(stream, r, flag + self.rank, number)
            for r in others:
                self.counters.wait(stream, flag + r, number)
                out[r] = list(buf[r, :counts[r]].clone().unbind(0))
            for r in others:
                self.counters.write(stream, r, ack + self.rank, number)
        handshake(number, "ipc exchange")
        return out


def channel(device) -> Channel:
    """This process's :class:`Channel` on ``device`` (made on first use,
    collectively)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _CHANNELS:
        _CHANNELS[device] = Channel(device)
    return _CHANNELS[device]


def close() -> None:
    """Release every exported buffer and mapping of this process: wait
    for the card, meet the peers (they are done reading and writing),
    drop the mappings, meet them again, then free.  A no-op without
    any."""
    import torch.distributed as dist

    if not _SHARED:
        return
    torch.cuda.synchronize()
    dist.barrier()
    _CHANNELS.clear()
    from mpqe_tpu_torch.ops import ring

    ring._LINKS.clear()
    _SHARED.clear()
    torch.cuda.ipc_collect()
    dist.barrier()
    torch.cuda.empty_cache()
