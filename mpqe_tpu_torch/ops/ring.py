"""The ring-halo R-GCN layer with a hand-scheduled ring (counterpart of
``mpqe_tpu/ops/pallas_ring.py``): K8 as a Hopper CUDA kernel.

:func:`rgcn_ring_halo_rdma` computes what ``parallel/halo.py``'s
``rgcn_ring_halo`` computes (basis layers only), with the reference
kernel's schedule.  Each part p of the mesh axis owns a double buffer
``comm [2, block, d]`` on its device; at hop s its slot ``s % 2`` holds
the node block of part ``(p - s) % P``, and part p aggregates the edge
bucket ``[p, (p - s) % P]`` from it (``csrc/ring.cu``, one launch per
hop for all the parts on a device) while the copy of hop s + 1 moves the
block on to part p + 1's other slot.  CUDA events take the place of the
TPU kernel's DMA semaphores:

* the copies run on a copy stream, one device-to-device ``copy_`` per
  part (``.to(device)`` semantics across cards);
* the hop-(s+1) copy into part p + 1's slot ``(s + 1) % 2`` waits on the
  event recorded after that part's hop-(s-1) aggregate, the last read of
  the slot: the ack token ("your slot is free");
* the hop-(s+1) aggregate waits on the copy's event: the receive
  semaphore.

As in the reference, tokens are posted after the aggregates of hops
0 .. P-3 and consumed by the copies of hops 2 .. P-1 (the waits at hops
1 .. P-2 of the TPU kernel), so a ring of 2 has none.  The copy of hop
s + 1 is issued before the aggregate of hop s and overlaps it, as the
RDMA overlaps it on the TPU.  All slots are allocated before the first
hop on the compute stream and marked for the copy stream
(``record_stream``).  The self-loop and bias, ``x_p @ w_self + agg +
bias``, run outside the kernel.

The kernel's arithmetic is fixed in order and rounding (``csrc/ring.cu``);
the plain version (:func:`ring_hop_reference`, driven by
:func:`rgcn_ring_halo_rdma_reference`) runs the same operations in the
same order, so the two agree bit for bit on the card.  The wrapper takes
the plain version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  Like the reference kernel, K8 is forward only (no VJP):
a call in grad mode on a tensor that requires grad raises.

The same schedule runs where the parts sit on different cards, but only a
ring of parts on one card has run it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List

import torch

from mpqe_tpu_torch.ops import cuda_build
from mpqe_tpu_torch.ops.cuda_build import refuse_grad
from mpqe_tpu_torch.ops.rgcn import RGCNLayer
from mpqe_tpu_torch.parallel import mesh as mesh_lib
from mpqe_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class RingGroup:
    """The parts of the ring that live on one device, and what one hop's
    aggregation reads and writes there.  ``parts`` are global part ids,
    ascending; every array is indexed by the local part first:
    ``comm [L, 2, block, d]``, ``out [L, block, d_out]``, the edge rows
    ``src``/``dst``/``rel``/``norm [L, P, e_max]``, the destination layout
    ``perm [L, P, e_max]`` and ``offs [L, P, block + 1]``, the layer's
    ``basis`` and ``coeff``."""

    device: torch.device
    parts: List[int]
    parts_t: torch.Tensor
    comm: torch.Tensor
    out: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    rel: torch.Tensor
    norm: torch.Tensor
    perm: torch.Tensor
    offs: torch.Tensor
    basis: torch.Tensor
    coeff: torch.Tensor


def ring_layout(dst_local: torch.Tensor, block: int):
    """Each bucket's destination order, made on the ids' device: ``perm``
    (int32, the edge positions of every ``[..., e_max]`` bucket stably
    sorted by destination, out-of-range destinations last) and ``offs``
    (int32 ``[..., block + 1]``, row r's edges ``perm[offs[r]:offs[r+1]]``).
    """
    d = dst_local.long()
    key = torch.where((d >= 0) & (d < block), d, block)
    keys, perm = torch.sort(key, dim=-1, stable=True)
    lead = keys.shape[:-1]
    flat = keys.reshape(-1, keys.shape[-1])
    bounds = torch.arange(block + 1, device=d.device).expand(flat.shape[0], -1)
    offs = torch.searchsorted(flat, bounds.contiguous())
    return (perm.to(torch.int32).contiguous(),
            offs.reshape(*lead, block + 1).to(torch.int32).contiguous())


# ----------------------------------------------------------------------
# Plain version of one hop
# ----------------------------------------------------------------------
def ring_hop_reference(g: RingGroup, n_parts: int, hop: int, cur: int,
                       n_rels: int) -> None:
    """Plain version of the kernel's hop, for every part of ``g``: the same
    operations in the same order (a loop over k with ``mul`` then ``add``,
    bases ascending, then ``* norm``; each bucket's destination sum by its
    stable order, one ``index_add_`` per rank), adding into ``g.out``."""
    L, _, block, K = g.comm.shape
    dev = g.device
    e_max = g.src.shape[-1]
    li = torch.arange(L, device=dev)
    sb = (g.parts_t.long() - hop) % n_parts
    src, rel = g.src[li, sb].long(), g.rel[li, sb].long()
    norm, perm, offs = g.norm[li, sb], g.perm[li, sb].long(), g.offs[li, sb]
    slot = g.comm[:, cur]
    ok = (src >= 0) & (src < block)
    xs = slot[li[:, None], src.clamp(0, block - 1)]
    xs = torch.where(ok[..., None], xs, torch.zeros((), device=dev))
    valid = (rel >= 0) & (rel < n_rels)
    c = torch.where(valid[..., None], g.coeff[rel.clamp(0, n_rels - 1)],
                    torch.zeros((), device=dev))
    N = g.basis.shape[2]
    acc = torch.zeros((L, e_max, N), device=dev)
    h = torch.empty_like(acc)
    tmp = torch.empty_like(acc)
    for b in range(g.basis.shape[0]):
        h.zero_()
        for k in range(K):
            torch.mul(xs[..., k:k + 1], g.basis[b, k], out=tmp)
            h.add_(tmp)
        torch.mul(c[..., b:b + 1], h, out=tmp)
        acc.add_(tmp)
    m = acc * norm[..., None]
    # bucket order within each destination row: position in the stable
    # sort minus the row's first position
    d_sorted = g.dst[li, sb].long().gather(1, perm)
    pos = torch.arange(e_max, device=dev).expand(L, -1)
    in_rng = (d_sorted >= 0) & (d_sorted < block)
    rank = pos - offs.long().gather(1, d_sorted.clamp(0, block))
    out = g.out.view(L * block, N)
    rows = (d_sorted + li[:, None] * block)[in_rng]
    m_sorted = m[li[:, None], perm][in_rng]
    rank = rank[in_rng]
    if rank.numel():
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            out.index_add_(0, rows[sel], m_sorted[sel])


# ----------------------------------------------------------------------
# The kernel
# ----------------------------------------------------------------------
_KERNEL = None


def _kernel():
    """The built K8 library, its entry points' argument types set."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("ring", ["ring.cu"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mpqe_ring_hop.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p, p,
                                      p, p, i, p, i, p, i, p, p]
        lib.mpqe_ring_hop.restype = i
        lib.mpqe_ring_smem_bytes.argtypes = [i, i]
        lib.mpqe_ring_smem_bytes.restype = ctypes.c_longlong
        lib.mpqe_ring_max_smem.argtypes = [i]
        lib.mpqe_ring_max_smem.restype = ctypes.c_longlong
        _KERNEL = lib
    return _KERNEL


def _check_width(lib, K: int, bb: int, device: torch.device) -> None:
    need = lib.mpqe_ring_smem_bytes(K, bb)
    have = lib.mpqe_ring_max_smem(device.index or 0)
    if need > have:
        raise ValueError(
            f"rgcn_ring_halo_rdma: width {K} with {bb} bases needs {need} B "
            f"of shared memory per block, the card allows {have}")


def _launch_hop(g: RingGroup, n_parts: int, hop: int, cur: int,
                n_rels: int) -> None:
    """One hop's kernel on ``g``'s device, on its current stream, counted
    in ``rgcn_ring_halo_rdma.launches``."""
    lib = _kernel()
    L, _, block, K = g.comm.shape
    bb, _, N = g.basis.shape
    for name in ("comm", "out", "src", "dst", "rel", "norm", "perm", "offs",
                 "basis", "coeff", "parts_t"):
        t = getattr(g, name)
        if not t.is_contiguous() or t.device != g.device:
            raise ValueError(f"rgcn_ring_halo_rdma: {name} must be "
                             f"contiguous on {g.device}")
    with torch.cuda.device(g.device):
        err = lib.mpqe_ring_hop(
            g.comm.data_ptr(), g.parts_t.data_ptr(), L, n_parts, hop, cur,
            block, K, N, g.src.data_ptr(), g.dst.data_ptr(),
            g.rel.data_ptr(), g.norm.data_ptr(), g.perm.data_ptr(),
            g.offs.data_ptr(), g.src.shape[-1], g.basis.data_ptr(), bb,
            g.coeff.data_ptr(), n_rels, g.out.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K8 kernel launch failed: cudaError {err}")
    rgcn_ring_halo_rdma.launches += 1


# ----------------------------------------------------------------------
# The ring
# ----------------------------------------------------------------------
def _check_args(layer, x_padded, edges, n_parts: int):
    if layer.basis is None:
        raise ValueError("rgcn_ring_halo_rdma requires basis decomposition")
    if x_padded.dim() != 2 or x_padded.dtype != torch.float32:
        raise ValueError(f"x_padded must be [P * block, d] float32, got "
                         f"{tuple(x_padded.shape)} {x_padded.dtype}")
    if x_padded.shape[0] % n_parts:
        raise ValueError(f"{x_padded.shape[0]} rows do not split into "
                         f"{n_parts} parts")
    shape = edges[0].shape
    if len(shape) != 3 or shape[:2] != (n_parts, n_parts):
        raise ValueError(f"edge arrays must be [{n_parts}, {n_parts}, e_max],"
                         f" got {tuple(shape)}")
    for t in edges:
        if t.shape != shape:
            raise ValueError("edge arrays differ in shape")
    for t in edges[:3]:
        if t.is_floating_point() or t.is_complex():
            raise ValueError(f"src, dst and rel must be integers, got "
                             f"{t.dtype}")


def _groups(devs, layer, xs, edges, block: int) -> Dict:
    """One :class:`RingGroup` per distinct device of the axis, slots and
    outputs allocated on its current stream, slot 0 holding each part's
    own block."""
    by_dev: Dict[torch.device, List[int]] = {}
    for p, dev in enumerate(devs):
        by_dev.setdefault(dev, []).append(p)
    d_out = layer.basis.shape[2]
    groups = {}
    for dev, parts in by_dev.items():
        idx = torch.tensor(parts, device=dev)
        src, dst, rel, norm = (
            t.to(dev)[idx].to(dtype).contiguous()
            for t, dtype in zip(edges, (torch.int32,) * 3 + (torch.float32,)))
        perm, offs = ring_layout(dst, block)
        comm = torch.empty((len(parts), 2, block, xs[0].shape[1]),
                           device=dev)
        comm[:, 0] = torch.stack([xs[p] for p in parts])
        groups[dev] = RingGroup(
            device=dev, parts=parts,
            parts_t=idx.to(torch.int32), comm=comm,
            out=torch.zeros((len(parts), block, d_out), device=dev),
            src=src, dst=dst, rel=rel, norm=norm, perm=perm, offs=offs,
            basis=layer.basis.detach().to(dev, torch.float32).contiguous(),
            coeff=layer.coeff.detach().to(dev, torch.float32).contiguous())
    return groups


def _copies(groups, where, n_parts: int, cur: int, nxt: int, into) -> None:
    """The hop's copies into the parts of ``into``: part p's slot ``cur``
    to part p + 1's slot ``nxt``."""
    for q in into.parts:
        p = (q - 1) % n_parts
        gp, ip = where[p]
        into.comm[into.parts.index(q), nxt].copy_(
            groups[gp].comm[ip, cur], non_blocking=True)


def _ring(mesh: Mesh, layer: RGCNLayer, x_padded, edges, n_rels: int,
          axis: str, hop_fn: Callable, streams: bool) -> torch.Tensor:
    devs = mesh.axis_devices(axis)
    n_parts = len(devs)
    _check_args(layer, x_padded, edges, n_parts)
    xs = mesh_lib.scatter_blocks(x_padded, devs)
    block = xs[0].shape[0]
    groups = _groups(devs, layer, xs, edges, block)
    where = {p: (dev, groups[dev].parts.index(p))
             for dev in groups for p in groups[dev].parts}
    if streams:
        _ring_streams(groups, where, n_parts, n_rels, hop_fn)
    else:
        for s in range(n_parts):
            cur, nxt = s % 2, (s + 1) % 2
            if s + 1 < n_parts:
                for g in groups.values():
                    _copies(groups, where, n_parts, cur, nxt, g)
            for g in groups.values():
                hop_fn(g, n_parts, s, cur, n_rels)
    outs = []
    for p, dev in enumerate(devs):
        gd, i = where[p]
        outs.append(xs[p] @ layer.w_self.to(dev) + groups[gd].out[i]
                    + layer.bias.to(dev))
    return mesh_lib.gather_blocks(outs, x_padded.device)


def _ring_streams(groups, where, n_parts: int, n_rels: int,
                  hop_fn: Callable) -> None:
    """The ring on CUDA streams: per device the current (compute) stream
    runs the aggregates, a copy stream the copies, events order them."""
    compute = {dev: torch.cuda.current_stream(dev) for dev in groups}
    copy = {dev: torch.cuda.Stream(dev) for dev in groups}
    for dev, g in groups.items():
        g.comm.record_stream(copy[dev])

    def recorded(stream):
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    filled = {dev: recorded(compute[dev]) for dev in groups}  # slot 0 set
    recv: Dict = {}  # (device, slot) -> the copy into it has landed
    ack: Dict = {}  # (device, slot) -> its last aggregate has read it
    for s in range(n_parts):
        cur, nxt = s % 2, (s + 1) % 2
        if s + 1 < n_parts:
            for dev, g in groups.items():
                senders = {where[(q - 1) % n_parts][0] for q in g.parts}
                for sd in senders:
                    copy[dev].wait_event(filled[sd] if s == 0
                                         else recv[(sd, cur)])
                if s > 0:
                    # the ack token: the receivers' slot nxt is free
                    copy[dev].wait_event(ack[(dev, nxt)])
                with torch.cuda.stream(copy[dev]):
                    _copies(groups, where, n_parts, cur, nxt, g)
                recv[(dev, nxt)] = recorded(copy[dev])
        for dev, g in groups.items():
            if s > 0:
                compute[dev].wait_event(recv[(dev, cur)])
            with torch.cuda.stream(compute[dev]):
                hop_fn(g, n_parts, s, cur, n_rels)
            if s + 1 < n_parts - 1:
                ack[(dev, cur)] = recorded(compute[dev])


def rgcn_ring_halo_rdma(
    mesh: Mesh,
    layer: RGCNLayer,
    x_padded: torch.Tensor,  # [n_parts * block, d]
    pe_src_local: torch.Tensor,  # [P, P, e_max] (dst block, src block, edge)
    pe_dst_local: torch.Tensor,
    pe_rel: torch.Tensor,
    pe_norm: torch.Tensor,
    n_rels: int,
    axis: str = "data",
) -> torch.Tensor:
    """K8: one R-GCN layer (basis layers) over the ring of the mesh's
    ``axis``, with ``parallel/halo.py``'s ``partition_edges_ring`` layout;
    returns ``[n_parts * block, d_out]`` on ``x_padded``'s device.  CUDA
    tensors: one kernel launch per hop and device, counted in
    ``rgcn_ring_halo_rdma.launches``; CPU tensors: the plain version.
    ``ValueError`` for a full-weight layer, ``NotImplementedError`` in
    grad mode."""
    refuse_grad("rgcn_ring_halo_rdma", x_padded,
                *(p for p in layer.parameters()))
    edges = (pe_src_local, pe_dst_local, pe_rel, pe_norm)
    kinds = {d.type for d in mesh.axis_devices(axis)} | {x_padded.device.type}
    if kinds == {"cpu"}:
        return _ring(mesh, layer, x_padded, edges, n_rels, axis,
                     ring_hop_reference, streams=False)
    if kinds != {"cuda"}:
        raise ValueError(f"rgcn_ring_halo_rdma: devices {sorted(kinds)}; "
                         "all CPU (the plain version) or all CUDA")
    if layer.basis is not None:
        lib = _kernel()
        for dev in set(mesh.axis_devices(axis)):
            _check_width(lib, x_padded.shape[1], layer.basis.shape[0], dev)
    # through the module's name, so that a caller can wrap the launch
    return _ring(mesh, layer, x_padded, edges, n_rels, axis,
                 lambda *a: _launch_hop(*a), streams=True)


rgcn_ring_halo_rdma.launches = 0


def rgcn_ring_halo_rdma_reference(
    mesh: Mesh, layer: RGCNLayer, x_padded: torch.Tensor,
    pe_src_local: torch.Tensor, pe_dst_local: torch.Tensor,
    pe_rel: torch.Tensor, pe_norm: torch.Tensor, n_rels: int,
    axis: str = "data",
) -> torch.Tensor:
    """Plain version of :func:`rgcn_ring_halo_rdma` on any device: the same
    ring, double buffers and copies, hop by hop on the current stream,
    each hop's aggregation by :func:`ring_hop_reference`."""
    with torch.no_grad():
        return _ring(mesh, layer, x_padded,
                     (pe_src_local, pe_dst_local, pe_rel, pe_norm), n_rels,
                     axis, ring_hop_reference, streams=False)
