"""CUDA tensors between the processes of a group on one node: the card's
transport of ``multihost.exchange`` and of K8's ring across processes
(``ops/ring.py``) within a node, with the peer on the same card or on
another card of the host.  Between nodes no process can open another's
memory: there the tensors cross by NCCL (``multihost.exchange``'s
collective, K8's sends and receives), and :func:`channel` and
:meth:`Shared.mapped` raise ``RuntimeError`` rather than open a handle
exported on another node (``multihost.nodes``: the host name and
torchrun's ``GROUP_RANK``).

Each process allocates its receive buffers once per key (shape, dtype,
counts) and exports them (:class:`Shared`): the allocation that holds a
buffer (``cuMemGetAddressRange``) by its IPC handle
(``cuIpcGetMemHandle``) and the buffer's offset in it.  The handles are
swapped over the group (``all_gather_object``), and each process opens a
peer's handle in the context of the card whose streams write into it
(``cuIpcOpenMemHandle`` with ``CU_IPC_MEM_LAZY_ENABLE_PEER_ACCESS``): on
another card that is a peer mapping, which ``RuntimeError`` refuses where
``torch.cuda.can_device_access_peer`` says the two cards have none (a
mapping opened in another card's context is not one the writing card's
streams may use: the card's driver refuses their counter writes).  A
handle is opened once per card of a process, never in the process that
exported it.  A peer's buffer is then an address here (:class:`Mapped`):
a block moves by one ``cuMemcpyAsync`` into it, on the sender's stream.

Ordering is by counters in device memory, not by events: an
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
(``mpqe_tpu/ops/pallas_ring.py``).  :class:`Counters` checks that the
driver has the stream memory operations (the 32-bit wait and write of
CUDA 12's v2 API, which every device of such a driver has; a driver
with only the v1 entry points must report
``CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1``) and raises where it
has not.  A stream's wait has no timeout of its own: after enqueuing its
part of an exchange each process meets the others on the host
(:func:`handshake`, a gloo ``all_gather`` under the group's timeout), so
a peer that never sends raises there, before any synchronisation waits
on a write that will not come.  The exported buffers must outlive the
peers' use of them: :func:`close` synchronises, meets the peers, closes
its mappings, meets them again and only then frees.

Within a process, parts on two cards copy into each other's buffers the
same way (:func:`copy_into` on the receiver's stream) once
:func:`peer_access` has enabled peer access between the two cards: a
pair without it raises, so no block is staged through the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from contextlib import contextmanager
from typing import Dict, List, Sequence, Set, Tuple

import torch

_WAIT_GEQ = 0x0  # CU_STREAM_WAIT_VALUE_GEQ: (int32)(*addr - value) >= 0
_WRITE_FENCED = 0x0  # CU_STREAM_WRITE_VALUE_DEFAULT: fences prior writes
_LAZY_PEER = 0x1  # CU_IPC_MEM_LAZY_ENABLE_PEER_ACCESS
_MEM_OPS_V1 = 92  # CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1
_ALREADY_ENABLED = 704  # CUDA_ERROR_PEER_ACCESS_ALREADY_ENABLED
_LIBCUDA = None
_CONTEXTS: Dict[int, ctypes.c_void_p] = {}  # card -> its primary context
_PEERS: Set[Tuple[int, int]] = set()  # card pairs with peer access on
_OPENED: Dict[Tuple[bytes, int], int] = {}  # (handle, card) -> address
_CHANNELS: Dict[torch.device, "Channel"] = {}
_SHARED: List[torch.Tensor] = []  # exported buffers
_OPENED_FROM: Set[int] = set()  # the ranks whose exported memory was opened

_p, _u, _i = ctypes.c_void_p, ctypes.c_uint, ctypes.c_int
_ull, _sz = ctypes.c_ulonglong, ctypes.c_size_t


class _IpcHandle(ctypes.Structure):
    _fields_ = [("reserved", ctypes.c_ubyte * 64)]


# name: (argument types, alternative names)
_FUNCTIONS = {
    "cuInit": ([_u], ()),
    "cuDeviceGet": ([_p, _i], ()),
    "cuDeviceGetAttribute": ([_p, _i, _i], ()),
    "cuDevicePrimaryCtxRetain": ([_p, _i], ()),
    "cuCtxPushCurrent": ([_p], ("cuCtxPushCurrent_v2",)),
    "cuCtxPopCurrent": ([_p], ("cuCtxPopCurrent_v2",)),
    "cuCtxEnablePeerAccess": ([_p, _u], ()),
    "cuMemGetAddressRange": ([_p, _p, _ull], ("cuMemGetAddressRange_v2",)),
    "cuIpcGetMemHandle": ([ctypes.POINTER(_IpcHandle), _ull], ()),
    "cuIpcOpenMemHandle": ([_p, _IpcHandle, _u], ("cuIpcOpenMemHandle_v2",)),
    "cuIpcCloseMemHandle": ([_ull], ()),
    "cuMemcpyAsync": ([_ull, _ull, _sz, _p], ()),
    "cuStreamWaitValue32": ([_p, _ull, ctypes.c_uint32, _u],
                            ("cuStreamWaitValue32_v2",)),
    "cuStreamWriteValue32": ([_p, _ull, ctypes.c_uint32, _u],
                             ("cuStreamWriteValue32_v2",)),
}


def _libcuda():
    """``libcuda``'s functions this module calls, argument types set;
    ``"mem_ops_v2"``: whether the stream memory operations are the v2
    entry points."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        fns = {}
        for name, (argtypes, alt) in _FUNCTIONS.items():
            # the v2 entry point first, where the driver has one
            for sym in (*alt, name):
                fn = getattr(lib, sym, None)
                if fn is not None:
                    break
            else:
                raise RuntimeError(f"libcuda has no {name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        fns["mem_ops_v2"] = all(
            getattr(lib, f"cuStream{op}Value32_v2", None) is not None
            for op in ("Wait", "Write"))
        _check(fns["cuInit"](0), "cuInit")
        _LIBCUDA = fns
    return _LIBCUDA


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def _card(d) -> int:
    """A CUDA device's index (the current device for a bare ``cuda``)."""
    if isinstance(d, int):
        return d
    d = torch.device(d)
    if d.type != "cuda":
        raise ValueError(f"not a CUDA device: {d}")
    return torch.cuda.current_device() if d.index is None else d.index


def _context(card: int) -> ctypes.c_void_p:
    """The card's primary context (the one the CUDA runtime, and so
    PyTorch, uses), retained once."""
    if card not in _CONTEXTS:
        lib = _libcuda()
        dev, ctx = ctypes.c_int(), ctypes.c_void_p()
        _check(lib["cuDeviceGet"](ctypes.byref(dev), card), "cuDeviceGet")
        _check(lib["cuDevicePrimaryCtxRetain"](ctypes.byref(ctx), dev),
               "cuDevicePrimaryCtxRetain")
        _CONTEXTS[card] = ctx
    return _CONTEXTS[card]


@contextmanager
def _on(card: int):
    """The card's primary context current on this thread within."""
    lib = _libcuda()
    _check(lib["cuCtxPushCurrent"](_context(card)), "cuCtxPushCurrent")
    try:
        yield lib
    finally:
        _check(lib["cuCtxPopCurrent"](ctypes.byref(ctypes.c_void_p())),
               "cuCtxPopCurrent")


def peer_access(a, b) -> None:
    """Peer access between cards ``a`` and ``b``, both ways, enabled once
    per process; ``RuntimeError`` where ``torch.cuda.can_device_access_peer``
    says the pair has none (no copy between them is staged through the
    host).  A no-op for one card."""
    a, b = _card(a), _card(b)
    if a == b or (a, b) in _PEERS:
        return
    for x, y in ((a, b), (b, a)):
        if not torch.cuda.can_device_access_peer(x, y):
            raise RuntimeError(
                f"cuda:{x} has no peer access to cuda:{y}: a copy between "
                "them would be staged through the host, which this path "
                "does not do")
    for x, y in ((a, b), (b, a)):
        with _on(x) as lib:
            err = lib["cuCtxEnablePeerAccess"](_context(y), 0)
        if err not in (0, _ALREADY_ENABLED):
            _check(err, f"cuCtxEnablePeerAccess cuda:{x} -> cuda:{y}")
        _PEERS.add((x, y))


def stream_mem_ops(card: int) -> None:
    """``RuntimeError`` unless the card's driver has the stream memory
    operations: the v2 entry points (CUDA 12's, on every device: the v2
    attributes cover only the 64-bit and NOR operations, which are not
    used), or the v1 ones with ``CAN_USE_STREAM_MEM_OPS_V1`` set."""
    lib = _libcuda()
    if lib["mem_ops_v2"]:
        return
    dev, val = ctypes.c_int(), ctypes.c_int()
    _check(lib["cuDeviceGet"](ctypes.byref(dev), card), "cuDeviceGet")
    _check(lib["cuDeviceGetAttribute"](ctypes.byref(val), _MEM_OPS_V1, dev),
           "cuDeviceGetAttribute")
    if val.value != 1:
        raise RuntimeError(f"cuda:{card}: the driver has no stream memory "
                           "operations (cuStreamWaitValue32 / "
                           "cuStreamWriteValue32)")


def wait_value(stream: torch.cuda.Stream, addr: int, value: int) -> None:
    """``stream`` waits until the int32 at device address ``addr`` reaches
    ``value`` (signed, wrap-safe)."""
    with _on(stream.device.index) as lib:
        _check(lib["cuStreamWaitValue32"](
            stream.cuda_stream, addr, value & 0xFFFFFFFF, _WAIT_GEQ),
            "cuStreamWaitValue32")


def write_value(stream: torch.cuda.Stream, addr: int, value: int) -> None:
    """``stream`` writes ``value`` to the int32 at ``addr`` once its earlier
    work (and its writes) are done."""
    with _on(stream.device.index) as lib:
        _check(lib["cuStreamWriteValue32"](
            stream.cuda_stream, addr, value & 0xFFFFFFFF, _WRITE_FENCED),
            "cuStreamWriteValue32")


def copy_into(addr: int, src: torch.Tensor, stream: torch.cuda.Stream
              ) -> None:
    """On ``stream``: ``src``'s bytes to device address ``addr`` (a
    :class:`Mapped` address, or a tensor of another card whose peer access
    :func:`peer_access` enabled)."""
    if not src.is_contiguous():
        raise ValueError("copy_into takes a contiguous source")
    with _on(stream.device.index) as lib:
        _check(lib["cuMemcpyAsync"](addr, src.data_ptr(),
                                    src.numel() * src.element_size(),
                                    stream.cuda_stream), "cuMemcpyAsync")


def copy_between(dst: torch.Tensor, src: torch.Tensor,
                 stream: torch.cuda.Stream) -> None:
    """``dst.copy_(src)`` on ``stream`` for two contiguous tensors of one
    dtype and size on two cards: one peer copy (peer access enabled
    first; a pair without it raises)."""
    if not dst.is_contiguous() or dst.dtype != src.dtype or \
            dst.numel() != src.numel():
        raise ValueError("copy_between takes contiguous tensors of one "
                         "dtype and size")
    peer_access(dst.device, src.device)
    copy_into(dst.data_ptr(), src, stream)


def _world():
    import torch.distributed as dist

    return dist.get_world_size(), dist.get_rank()


@dataclasses.dataclass(frozen=True)
class Mapped:
    """A peer process's tensor opened in this process: its address here
    (valid on the card that opened it), shape and dtype.  Only copies into
    it and counter writes reach it."""

    ptr: int
    shape: tuple
    dtype: torch.dtype

    def addr(self, *index: int) -> int:
        """The address of the element at ``index`` (leading axes; the
        rest 0), row-major."""
        off = 0
        for k, i in enumerate(index):
            off += i * math.prod(self.shape[k + 1:])
        return self.ptr + off * torch.empty((), dtype=self.dtype
                                            ).element_size()


def _open(handle: bytes, card: int, owner: int) -> int:
    """The allocation of ``handle`` (on the exporter's card ``owner``)
    opened in the context of this process's ``card``, once."""
    key = (handle, card)
    if key not in _OPENED:
        if owner != card and not torch.cuda.can_device_access_peer(card,
                                                                   owner):
            raise RuntimeError(f"cuda:{card} has no peer access to "
                               f"cuda:{owner}, where the peer's buffer is")
        ptr = ctypes.c_ulonglong()
        h = _IpcHandle.from_buffer_copy(handle)
        with _on(card) as lib:
            _check(lib["cuIpcOpenMemHandle"](ctypes.byref(ptr), h,
                                             _LAZY_PEER),
                   "cuIpcOpenMemHandle")
        _OPENED[key] = ptr.value
    return _OPENED[key]


class Shared:
    """Every process's tensor of one role (collective to make: each
    process passes its own, contiguous, on its card).  ``mapped(r, card)``
    is process r's tensor opened in the context of this process's
    ``card`` (on first use), ``peers[r]`` the card it lives on."""

    def __init__(self, t: torch.Tensor):
        import torch.distributed as dist

        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"ipc.Shared takes a contiguous CUDA tensor, "
                             f"got {t.device}")
        world, self.rank = _world()
        card = _card(t.device)
        base, size, handle = ctypes.c_ulonglong(), ctypes.c_size_t(), \
            _IpcHandle()
        with _on(card) as lib:
            _check(lib["cuMemGetAddressRange"](
                ctypes.byref(base), ctypes.byref(size), t.data_ptr()),
                "cuMemGetAddressRange")
            _check(lib["cuIpcGetMemHandle"](ctypes.byref(handle),
                                            base.value),
                   "cuIpcGetMemHandle (an allocation of cudaMalloc only)")
        info = (bytes(handle.reserved), t.data_ptr() - base.value, card,
                tuple(t.shape), str(t.dtype).split(".")[-1])
        # a peer writes into t as soon as it has the handle: what this
        # process enqueued on t (its zero fill) must be done before
        torch.cuda.synchronize(card)
        self.infos = [None] * world
        dist.all_gather_object(self.infos, info)
        self.peers = [i[2] for i in self.infos]
        _SHARED.append(t)

    def mapped(self, r: int, card: int) -> Mapped:
        """``RuntimeError`` for a process on another node."""
        from mpqe_tpu_torch.parallel import multihost

        handle, off, owner, shape, dtype = self.infos[r]
        if r == self.rank:
            raise ValueError("a process's own tensor is not opened by IPC")
        if not multihost.same_node(self.rank, r):
            raise RuntimeError(f"process {r} is on another node than "
                               f"process {self.rank}: its memory is not "
                               "opened by CUDA IPC (tensors between nodes "
                               "cross by NCCL)")
        ptr = _open(handle, card, owner)
        _OPENED_FROM.add(r)
        return Mapped(ptr + off, shape, getattr(torch, dtype))


def opened_from() -> List[int]:
    """The ranks whose exported memory this process has opened."""
    return sorted(_OPENED_FROM)


class Counters:
    """An int32 array of this process's in device memory that peers write
    (collective to make), with every peer's shared.  ``RuntimeError`` when
    the driver has no stream memory operations."""

    def __init__(self, device: torch.device, n: int):
        self.device = torch.device("cuda", _card(device))
        stream_mem_ops(self.device.index)
        self.mine = torch.zeros((n,), dtype=torch.int32, device=self.device)
        self.peers = Shared(self.mine)

    def write(self, stream, peer: int, i: int, value: int) -> None:
        """``stream`` sets peer's counter ``i`` to ``value`` (after its
        earlier work)."""
        m = self.peers.mapped(peer, stream.device.index)
        write_value(stream, m.addr(i), value)

    def wait(self, stream, i: int, value: int) -> None:
        """``stream`` (of any card of this process) waits until this
        process's counter ``i`` reaches ``value``."""
        peer_access(stream.device, self.device)
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
            self.buffers[key] = (mine, Shared(mine))
        return self.buffers[key]

    def exchange(self, mine: Sequence[torch.Tensor], counts: Sequence[int],
                 shape: tuple, dtype) -> List[List[torch.Tensor]]:
        """``multihost.exchange``'s data: ``mine`` copied into row ``rank``
        of every peer's buffer, each peer's row of this process's buffer
        copied out once its flag says it landed, all on the current
        stream."""
        m = max(counts)
        key = (m, tuple(shape), dtype)
        buf, shared = self._buffer(key, (m, *shape), dtype)
        self.number += 1
        number, prev = self.number, self.last.get(key, 0)
        self.last[key] = number
        flag, ack = 0, self.world
        stream = torch.cuda.current_stream(self.device)
        card = self.device.index
        out: List[List[torch.Tensor]] = [[] for _ in range(self.world)]
        others = [r for r in range(self.world) if r != self.rank]
        if mine:
            src = torch.stack(list(mine))
            for r in others:
                # the peer has read what this process wrote there last
                self.counters.wait(stream, ack + r, prev)
                copy_into(shared.mapped(r, card).addr(self.rank), src,
                          stream)
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
    collectively); ``RuntimeError`` for a group over several nodes."""
    from mpqe_tpu_torch.parallel import multihost

    if not multihost.single_node():
        raise RuntimeError("ipc.channel joins the processes of one node; "
                           f"this group spans nodes {multihost.nodes()}: "
                           "multihost.exchange moves their CUDA tensors "
                           "by NCCL")
    device = torch.device("cuda", _card(device))
    if device not in _CHANNELS:
        _CHANNELS[device] = Channel(device)
    return _CHANNELS[device]


def close() -> None:
    """Release every exported buffer and mapping of this process: wait
    for the cards, meet the peers (they are done reading and writing),
    close the mappings, meet them again, then free.  A no-op without
    any."""
    import torch.distributed as dist

    if not _SHARED:
        return
    for card in sorted(_CONTEXTS):  # the cards this process touched
        torch.cuda.synchronize(card)
    dist.barrier()
    _CHANNELS.clear()
    from mpqe_tpu_torch.ops import ring

    ring._LINKS.clear()
    for (_, card), ptr in list(_OPENED.items()):
        with _on(card) as lib:
            _check(lib["cuIpcCloseMemHandle"](ptr), "cuIpcCloseMemHandle")
    _OPENED.clear()
    dist.barrier()
    _SHARED.clear()
    torch.cuda.empty_cache()
