"""The ring-halo R-GCN layer with a hand-scheduled ring (counterpart of
``mpqe_tpu/ops/pallas_ring.py``): K8 on Hopper.

:func:`rgcn_ring_halo_rdma` computes what ``parallel/halo.py``'s
``rgcn_ring_halo`` computes (basis layers only), with the reference
kernel's schedule.  The parts of the mesh axis that live on one device
share a double buffer ``comm [2, L, block, d]`` (slot-major, a zero row
after it); at hop s slot ``s % 2`` holds, for each part p, the node block
of part ``(p - s) % P``, and part p aggregates the edge bucket ``[p, (p -
s) % P]`` from it while the copy of hop s + 1 moves the blocks on to the
other slot.  CUDA events take the place of the TPU kernel's DMA
semaphores:

* the copies run on the receiving device's copy stream, made once and
  reused: a device's copies for a hop are at most two slice copies; a
  part whose neighbour lives on another card of the process receives its
  block by one peer copy on that stream (``parallel/ipc.py
  copy_between``: peer access is enabled once for each pair of cards, and
  a pair without it raises, so no block is staged through the host);
* the hop-(s+1) copy into slot ``(s + 1) % 2`` waits on the event recorded
  once the hop-(s-1) messages have read that slot: the ack token ("your
  slot is free");
* the hop-(s+1) aggregate waits on the copy's event: the receive
  semaphore;
* across cards, the hop-(s+1) copy into a card's slot also waits until
  the other cards' copies of hop s are done reading it, and each card's
  compute stream waits at the end of the call for the other cards' copy
  streams that read its slots (``record_stream`` marks only streams of
  the tensor's own card), so no slot is written or freed under a reader.

As in the reference, tokens are posted at hops 0 .. P-3 and consumed by
the copies of hops 2 .. P-1 (the waits at hops 1 .. P-2 of the TPU
kernel), so a ring of 2 has none.  The copy of hop s + 1 is issued before
the aggregate of hop s and overlaps it, as the RDMA overlaps it on the TPU.
All buffers are allocated before the first hop on the compute stream and
marked for the copy stream (``record_stream``).  The self-loop and bias,
``x @ w_self + agg + bias``, run outside the kernels, one ``addmm`` per
device.  A bf16 layer or bf16 rows are taken up to f32 here, every
operand, as the reference takes them (``pallas_ring.py:192-201``): the
output is f32 and equals K8 on the widened operands.

The kernels take the per-relation route (``csrc/ring.cu``): once per layer
call and device, the layouts (five layout kernels around one stable
``torch.sort`` of their keys, on the device, no host sync;
:func:`ring_route` is their plain version) and the W of each relation the
edges use, ``W_r = sum_b coeff[r, b] V_b`` (K5a's prologue,
``csrc/rgcn_fused.cu``); per hop the messages on the tensor cores in split
TF32 (K5's messages kernel) and the ordered destination sum
(``ring_sum_kernel``).  ``launches`` counts K8's own launches: per layer
call and device 6 + 2 P (the five layout kernels, the combine, then per
hop the messages and the sum; not the sort).  The plain version
(:func:`ring_hop_reference`, driven by
:func:`rgcn_ring_halo_rdma_reference`) keeps the TPU kernel's order (per
edge and basis, k ascending; each destination's edges in bucket order),
so the kernels are held to :func:`ring_gate`, not to its bits; the sum
order per destination is the plain version's.  The wrapper takes the
plain version for CPU tensors only; for CUDA tensors it launches the
kernels or raises.  Like the reference kernel, K8 is forward only (no
VJP): a call in grad mode on a tensor that requires grad raises.

The parts of the ring may also lie in different processes
(``parallel/multihost.py global_mesh``): each process holds a run of
consecutive parts, on one card or several, and computes only those.
Where the next process is on the same node (``multihost.same_node``),
the process's last part writes its block into the next process's first
part's slot, mapped by CUDA IPC (``parallel/ipc.py``) on the last part's
card, whatever card that slot lives on: the first part's comm buffer is
then allocated once per shape and exported.  Across processes,
counters in device memory take the place of the events: the copy stream
writes the receiver's ``recv`` counter of the slot after its copy, the
receiver's compute stream waits until it reaches the hop's number (the
receive semaphore), and once the hop's messages have read the slot the
receiver writes the sender's ``ack`` counter (once its own copies out of
that slot are done too), which the sender's copy stream waits for before
it writes that slot again (the ack token; posted at every hop, since the
buffers outlive the call); the next call writes the kept slots only once
this call's copies out of them are done.  Where the next process is on
another node, whose memory no process can map, the block goes by NCCL,
as the TPU kernel's RDMA reaches a chip of another host: at each hop the
sender copies its last part's slot into a staging buffer on its NCCL
card (``multihost.nccl_device``, which must hold its first part) and
sends it, the receiver receives into its first part's slot, one
``batch_isend_irecv`` on the group's own communicator (made before the
first hop by a collective, so a batch of a subset of the processes may
follow), issued from a boundary stream.  The receiver's compute stream
waits on the receive's work, recorded as an event, before the hop that
reads the slot (the receive semaphore), and issues the next receive into
a slot only after the hop that read it (NCCL's stream waits for the
issuing stream: the ack token); the sender's copies write a slot again
only after its staging copy read it, and the staging buffer only after
its last send is done.  A ring may mix the two boundaries (CUDA IPC
within each node, NCCL between them).  Within a process the events
stay.  After enqueuing a call each process meets the others on the host
(``ipc.handshake``, under the group's timeout).  Every process receives
the whole output: its rows' self term is one ``addmm`` over the whole
ring's rows (the call one process makes, so the rows equal one
process's bit for bit), then the parts' rows are exchanged
(``multihost.exchange``: CUDA IPC within a node, NCCL between nodes).
One process over several cards does the same on ``x``'s card.  On the
CPU the plain version runs the same schedule, each boundary block
crossing by a gloo send and receive, the pairing K8 runs by NCCL between
nodes.  Run on one H100 host: two processes on one card, two NCCL
processes on their own cards, two processes of two cards, and two node
groups (``torchrun --nnodes 2``, NCCL over sockets), pure and mixed.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from mpqe_tpu_torch.ops import cuda_build
from mpqe_tpu_torch.ops import rgcn_fused
from mpqe_tpu_torch.ops.cuda_build import refuse_grad
from mpqe_tpu_torch.ops.rgcn import RGCNLayer
from mpqe_tpu_torch.parallel import ipc
from mpqe_tpu_torch.parallel.mesh import Mesh

TOL_PLAIN = 1e-4  # max|diff| / max|ref| vs the plain version (K5's gate)
TOL_ORACLE = 1e-5  # ... vs the f32 oracles rgcn_ring_halo, rgcn_sparse
BIG_CHUNK, SMALL_CHUNK = 128, 32  # K5's big and small row tiles


@dataclasses.dataclass
class RingRoute:
    """The per-relation route's layouts for the parts on one device,
    hop-major (row s: what hop s reads), from :func:`ring_route`.  ``src``
    (int32, rows of the group's ``comm`` buffer: the hop's slot, or the
    zero row after both slots) and ``norm`` ``[P, n_chunks * chunk]``, and
    ``crel`` ``[P, n_chunks]`` (each chunk's relation, ``n_rels``: zero
    W): the parts' chunks one after another, the first ``live[s]`` of
    them real; ``drow [P, L, e_max]`` and ``doffs [P, L, block + 1]``:
    part i's bucket edges in destination order (stable in bucket order) as
    message rows, row r's at ``drow[s, i, doffs[s, i, r]:doffs[s, i, r +
    1]]``."""

    chunk: int
    n_chunks: int
    src: torch.Tensor
    norm: torch.Tensor
    crel: torch.Tensor
    live: torch.Tensor
    drow: torch.Tensor
    doffs: torch.Tensor


@dataclasses.dataclass
class RingGroup:
    """The parts of the ring that live on one device, and what one hop's
    aggregation reads and writes there.  ``parts`` are global part ids,
    ascending; ``comm [2, L, block, d]`` (a view of ``comm_rows [2 L
    block + 1, d]``, whose last row stays 0), ``out [L, block, d_out]``,
    the edge rows ``src``/``dst``/``rel``/``norm [L, P, e_max]``, the
    layer's ``basis`` and ``coeff``; the plain version's destination
    layout ``perm [L, P, e_max]`` and ``offs [L, P, block + 1]``, or the
    kernels' ``route`` (``hops``: each hop's pointers into it), the
    relation list ``comb`` of their combine, the combined weights ``w
    [n_rels + 1, d, d_out]`` and the messages' scratch ``msg``."""

    device: torch.device
    parts: List[int]
    comm_rows: torch.Tensor
    comm: torch.Tensor
    out: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    rel: torch.Tensor
    norm: torch.Tensor
    basis: torch.Tensor
    coeff: torch.Tensor
    parts_t: torch.Tensor
    perm: Optional[torch.Tensor] = None
    offs: Optional[torch.Tensor] = None
    route: Optional[RingRoute] = None
    comb: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None
    msg: Optional[torch.Tensor] = None
    hops: Optional[list] = None


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
    """Plain version of K8's hop, for every part of ``g``, in the TPU
    kernel's order (per edge and basis, a loop over k with ``mul`` then
    ``add``, bases ascending, then ``* norm``; each bucket's destination
    sum by its stable order, one ``index_add_`` per rank), adding into
    ``g.out``."""
    _, L, block, K = g.comm.shape
    dev = g.device
    e_max = g.src.shape[-1]
    li = torch.arange(L, device=dev)
    sb = (g.parts_t.long() - hop) % n_parts
    src, rel = g.src[li, sb].long(), g.rel[li, sb].long()
    norm, perm, offs = g.norm[li, sb], g.perm[li, sb].long(), g.offs[li, sb]
    slot = g.comm[cur]
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
# The kernels' route: layouts, its plain form, the gate
# ----------------------------------------------------------------------
def route_chunk(e_max: int, n_rels: int) -> int:
    """Rows per chunk: the big tile's 128 where the buckets hold enough
    edges per relation that padding each relation's run to 128 costs
    little, else the small tile's 32."""
    return BIG_CHUNK if e_max >= BIG_CHUNK * (n_rels + 1) else SMALL_CHUNK


def ring_route(src, dst, rel, norm, parts_t, n_parts: int, block: int,
               n_rels: int, chunk: int) -> RingRoute:
    """The layouts of :class:`RingRoute` for the parts ``parts_t`` (global
    ids, int) whose bucket rows are ``src``/``dst``/``rel``/``norm [L, P,
    e_max]``, on their device, with no host sync.  Per hop s and part i
    (bucket ``(p_i - s) % P``): the edges whose dst lies in ``[0, block)``
    sorted stably by relation (``rel`` outside ``[0, n_rels)``: slot
    ``n_rels``, a zero W), each relation's run padded to whole chunks; an
    edge whose dst lies outside is left out (the plain version adds
    nothing for it), one whose src lies outside reads the zero row.
    Capacity per bucket: ``ceil(e_max / chunk) + min(n_rels + 1, e_max)``
    chunks."""
    L, P, E = src.shape
    dev = src.device
    n_slots = n_rels + 1
    hop = torch.arange(P, device=dev)
    sb = (parts_t.long()[None, :] - hop[:, None]) % n_parts  # [P, L]
    li = torch.arange(L, device=dev)

    def take(t):  # hop-major bucket rows [P L, E]
        return t[li[None, :], sb].reshape(P * L, E)

    s, d, r, w = take(src).long(), take(dst).long(), take(rel).long(), take(
        norm)
    slot = torch.where((r >= 0) & (r < n_rels), r, n_rels)
    key = torch.where((d >= 0) & (d < block), slot, n_slots)
    ks, order = torch.sort(key, dim=1, stable=True)
    run = torch.searchsorted(ks, torch.arange(
        n_slots + 1, device=dev).expand(P * L, -1).contiguous())
    cnt = run[:, 1:] - run[:, :-1]
    nch = (cnt + chunk - 1) // chunk
    ch_start = nch.cumsum(1) - nch
    tot = nch.sum(1).view(P, L)
    base = (tot.cumsum(1) - tot).reshape(P * L, 1)
    cap = L * (-(-E // chunk) + min(n_slots, E))
    ksl = ks.clamp(max=n_slots - 1)
    rank = torch.arange(E, device=dev) - run.gather(1, ksl)
    gch = base + ch_start.gather(1, ksl) + rank // chunk  # chunk in the hop
    row = gch * chunk + rank % chunk  # message row in the hop
    live = ks < n_slots
    hop_of = torch.div(torch.arange(P * L, device=dev), L,
                       rounding_mode="floor")[:, None]
    part_of = torch.arange(P * L, device=dev)[:, None] % L
    rows = cap * chunk
    trash = P * rows  # index for the edges left out
    at = torch.where(live, hop_of * rows + row, trash).reshape(-1)
    s_sorted, w_sorted = s.gather(1, order), w.gather(1, order)
    zero_row = 2 * L * block
    srow = torch.where((s_sorted >= 0) & (s_sorted < block),
                       ((hop_of % 2) * L + part_of) * block + s_sorted,
                       zero_row)
    src_h = torch.full((P * rows + 1,), zero_row, dtype=torch.int32,
                       device=dev)
    src_h[at] = srow.reshape(-1).to(torch.int32)
    norm_h = torch.zeros((P * rows + 1,), dtype=torch.float32, device=dev)
    norm_h[at] = w_sorted.reshape(-1).to(torch.float32)
    crel_h = torch.full((P * cap + 1,), n_rels, dtype=torch.int32,
                        device=dev)
    crel_h[torch.where(live, hop_of * cap + gch, P * cap).reshape(-1)] = (
        ksl.reshape(-1).to(torch.int32))
    # the destination order, as message rows
    perm, offs = ring_layout(d.view(P, L, E), block)
    by_edge = torch.empty_like(row).scatter_(1, order, row)
    drow = by_edge.gather(1, perm.view(P * L, E).long())
    return RingRoute(
        chunk=chunk, n_chunks=cap, src=src_h[:-1].view(P, rows),
        norm=norm_h[:-1].view(P, rows), crel=crel_h[:-1].view(P, cap),
        live=tot.sum(1).to(torch.int32),
        drow=drow.view(P, L, E).to(torch.int32).contiguous(), doffs=offs)


def route_matches(got: RingRoute, want: RingRoute) -> bool:
    """Whether ``got`` (the layout kernels') equals ``want``
    (:func:`ring_route`'s) in all that the hop kernels read: the chunk
    shape, each hop's live chunk count and those chunks' relations, the
    destination order and its offsets, and the src row and norm of every
    message row an edge lands in (what padding rows and the chunks past
    the live ones hold reaches no sum)."""
    if (got.chunk, got.n_chunks) != (want.chunk, want.n_chunks):
        return False
    if not (torch.equal(got.live, want.live)
            and torch.equal(got.doffs, want.doffs)):
        return False
    P, L, E = want.drow.shape
    pos = torch.arange(E, device=want.drow.device)
    valid = pos < want.doffs[..., -1:].long()
    if not torch.equal(got.drow[valid], want.drow[valid]):
        return False
    live = torch.arange(want.n_chunks, device=pos.device) < want.live[:, None]
    hop = torch.arange(P, device=pos.device)[:, None, None].expand(P, L, E)
    rows = want.drow.long()
    return (torch.equal(got.crel[live], want.crel[live])
            and torch.equal(got.src[hop[valid], rows[valid]],
                            want.src[hop[valid], rows[valid]])
            and torch.equal(got.norm[hop[valid], rows[valid]],
                            want.norm[hop[valid], rows[valid]]))


def route_hop_reference(g: RingGroup, n_parts: int, hop: int, cur: int,
                        n_rels: int, messages: Optional[Callable] = None
                        ) -> None:
    """The kernels' hop on ``g.route`` in plain PyTorch, adding into
    ``g.out``: the messages by ``messages(x_rows, src, w_c, norm, chunk)``
    (default K5's plain product, ``rgcn_fused._chunk_products`` then
    ``* norm``; ``tools/k5_probe.py emulated_messages`` models the
    kernel's split-TF32 order) through ``g.w``, then each destination's
    messages in bucket order onto its running sum, as ``ring_sum_kernel``
    adds them."""
    rt = g.route
    rows, N = g.comm_rows, g.w.shape[2]
    crel = rt.crel[hop].long()
    src, norm = rt.src[hop], rt.norm[hop]
    w_c = g.w[crel]
    if messages is None:
        xs = rows[src.long()]
        m = rgcn_fused._chunk_products(xs, w_c, rt.chunk) * norm[:, None]
    else:
        m = messages(rows, src, w_c, norm, rt.chunk)
    L, block = g.out.shape[:2]
    out = g.out.view(L * block, N)
    drow, offs = rt.drow[hop].long(), rt.doffs[hop].long()
    E = drow.shape[1]
    li = torch.arange(L, device=out.device)[:, None]
    pos = torch.arange(E, device=out.device).expand(L, -1)
    # destination of each position: the row r with offs[r] <= pos < offs[r+1]
    dest = torch.searchsorted(offs[:, 1:].contiguous(), pos.contiguous(),
                              right=True)
    ok = pos < offs[:, -1:]
    rank = pos - offs.gather(1, dest.clamp(max=block - 1))
    dest = (dest + li * block)[ok]
    vals = m[drow[ok]]
    rank = rank[ok]
    if rank.numel():
        for k in range(int(rank.max()) + 1):
            sel = rank == k
            out.index_add_(0, dest[sel], vals[sel])


def combined_weights(basis: torch.Tensor, coeff: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of K8's combine: ``W [n_rels + 1, d, d_out]``,
    ``W_r = sum_b coeff[r, b] V_b`` b ascending (K5a's ``combine_basis``),
    and a zero W for slot n_rels."""
    pad = torch.cat([coeff, coeff.new_zeros((1, coeff.shape[1]))])
    return rgcn_fused.combine_basis(basis, pad)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def ring_gate(got: torch.Tensor, plain: torch.Tensor,
              oracles=()) -> dict:
    """K8 held to K5's gates: ``ok`` when max|diff| / max|ref| is <=
    ``TOL_PLAIN`` against the plain version and <= ``TOL_ORACLE`` against
    each f32 oracle ``(got_rows, oracle)`` pair (``rgcn_ring_halo``'s
    output, ``rgcn_sparse``'s on the real rows); the figures beside it."""
    e_plain = _rel(got, plain)
    e_or = [_rel(a, b) for a, b in oracles]
    finite = bool(torch.isfinite(got).all())
    return {"ok": finite and e_plain <= TOL_PLAIN
            and all(e <= TOL_ORACLE for e in e_or),
            "err_vs_plain": e_plain, "err_vs_oracles": e_or,
            "finite": finite}


def ring_controls(edges, n_rels: int, block: int):
    """The two negative controls' edge arrays ``(src, dst, rel, norm)``:
    in the first real edge of part 0's bucket with the largest norm, its
    ``rel`` moved to the next relation, and its ``src`` moved to another
    row of the block.  The plain version on either must fail
    :func:`ring_gate` against the kernel on the true edges."""
    src, dst, rel, norm = edges
    real = ((dst[0] >= 0) & (dst[0] < block) & (src[0] >= 0)
            & (src[0] < block) & (rel[0] >= 0) & (rel[0] < n_rels))
    score = torch.where(real, norm[0].abs(), torch.zeros_like(norm[0]))
    flat = int(torch.argmax(score.reshape(-1)))
    b, e = divmod(flat, src.shape[-1])
    bad_rel, bad_src = rel.clone(), src.clone()
    bad_rel[0, b, e] = (rel[0, b, e] + 1) % n_rels
    bad_src[0, b, e] = (src[0, b, e] + 1) % block
    return (src, dst, bad_rel, norm), (bad_src, dst, rel, norm)


# ----------------------------------------------------------------------
# The kernels
# ----------------------------------------------------------------------
_KERNEL = None
_COPY_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_PARTS: Dict[tuple, torch.Tensor] = {}  # (device, parts) -> int32 ids
_LINKS: Dict[tuple, "_Link"] = {}  # (first, last, L, block, d) -> the link
RECV, ACK = 0, 2  # the counters of slot k: RECV + k, ACK + k


def _kernel():
    """The built K8 library (``csrc/ring.cu``), its entry point's argument
    types set."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("ring", ["ring.cu"])
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.mpqe_ring_sum.argtypes = [p, i, p, p, i, i, i, i, p, p]
        lib.mpqe_ring_sum.restype = i
        lib.mpqe_ring_route_keys.argtypes = [p, p, p, i, i, i, i, i, p, p, i,
                                             p]
        lib.mpqe_ring_route_keys.restype = i
        lib.mpqe_ring_route.argtypes = [p, p, p, i, i, i, i, i, i, ll, i, p,
                                        p, p, p, p, p, p, p, p, p, p, p, p,
                                        p]
        lib.mpqe_ring_route.restype = i
        _KERNEL = lib
    return _KERNEL


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"K8 {what} launch failed: cudaError {err}")


def _launch_route(g: RingGroup, n_parts: int, block: int,
                  n_rels: int) -> None:
    """``g.route``, ``g.comb`` (the relations its edges use, for the
    combine) and the zero row after both slots, on ``g``'s device's
    current stream: the layout kernels (five launches, counted) around
    one stable ``torch.sort`` of their keys; no host sync."""
    lib = _kernel()
    L, P, E = g.src.shape
    dev, K = g.device, g.comm_rows.shape[1]
    chunk = route_chunk(E, n_rels)
    cap = L * (-(-E // chunk) + min(n_rels + 1, E))
    rows = cap * chunk
    i32 = dict(dtype=torch.int32, device=dev)
    keys = torch.empty((2 * P * L, E), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _check(lib.mpqe_ring_route_keys(
            g.dst.data_ptr(), g.rel.data_ptr(), g.parts_t.data_ptr(), L,
            n_parts, E, block, n_rels, keys.data_ptr(),
            g.comm_rows[-1].data_ptr(), K, stream), "layout keys")
        rgcn_ring_halo_rdma.launches += 1
        sk, order = torch.sort(keys, dim=1, stable=True)
        rt = RingRoute(
            chunk=chunk, n_chunks=cap, src=torch.empty((P, rows), **i32),
            norm=torch.empty((P, rows), dtype=torch.float32, device=dev),
            crel=torch.empty((P, cap), **i32), live=torch.empty((P,), **i32),
            drow=torch.empty((P, L, E), **i32),
            doffs=torch.empty((P, L, block + 1), **i32))
        g.comb = torch.empty((n_rels + 1,), **i32)
        scratch = torch.empty((P * L * (3 * (n_rels + 1) + 1 + E) + n_rels,),
                              **i32)
        runs = scratch[:P * L * 3 * (n_rels + 1)]
        tot = scratch[runs.numel():runs.numel() + P * L]
        present = scratch[runs.numel() + P * L:][:n_rels]
        edge_row = scratch[-P * L * E:]
        _check(lib.mpqe_ring_route(
            g.src.data_ptr(), g.norm.data_ptr(), g.parts_t.data_ptr(), L,
            n_parts, E, block, n_rels, chunk, rows, cap, sk.data_ptr(),
            order.data_ptr(), runs.data_ptr(), tot.data_ptr(),
            present.data_ptr(), edge_row.data_ptr(), rt.src.data_ptr(),
            rt.norm.data_ptr(), rt.crel.data_ptr(), rt.live.data_ptr(),
            rt.drow.data_ptr(), rt.doffs.data_ptr(), g.comb.data_ptr(),
            stream), "layout")
    rgcn_ring_halo_rdma.launches += 4
    g.route = rt
    # each hop's pointers into the layouts, taken once
    rows4, cap4, e4 = rows * 4, cap * 4, L * E * 4
    g.hops = [(rt.src.data_ptr() + s * rows4, rt.crel.data_ptr() + s * cap4,
               rt.live.data_ptr() + s * 4, rt.norm.data_ptr() + s * rows4,
               rt.drow.data_ptr() + s * e4,
               rt.doffs.data_ptr() + s * L * (block + 1) * 4)
              for s in range(P)]


def _launch_combine(g: RingGroup, n_rels: int) -> None:
    """``g.w``: the W of every relation ``g``'s edges use and the zero W,
    by K5a's prologue over ``g.comb``, on ``g``'s device's current stream
    (one launch)."""
    bb, K, N = g.basis.shape
    with torch.cuda.device(g.device):
        _check(rgcn_fused._kernel().mpqe_rgcn_combine(
            g.basis.data_ptr(), bb, g.coeff.data_ptr(), g.comb.data_ptr(),
            n_rels + 1, n_rels, K, N, g.w.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream), "combine")
    rgcn_ring_halo_rdma.launches += 1


def _launch_hop(g: RingGroup, n_parts: int, hop: int, cur: int,
                n_rels: int, read: Callable = None) -> None:
    """One hop on ``g``'s device, on its current stream: the messages (K5's
    kernel; then ``read()``, the slot's last reader done), then the
    destination sum; two launches, counted in
    ``rgcn_ring_halo_rdma.launches``."""
    rt = g.route
    _, L, block, K = g.comm.shape
    N = g.w.shape[2]
    src, crel, live, norm, drow, doffs = g.hops[hop]
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        _check(rgcn_fused._kernel().mpqe_rgcn_msg_live(
            g.comm_rows.data_ptr(), g.comm_rows.shape[0], src,
            g.w.data_ptr(), n_rels + 1, crel, live, norm, rt.n_chunks,
            rt.chunk, K, N, g.msg.data_ptr(), stream), "messages")
        rgcn_ring_halo_rdma.launches += 1
        if read is not None:
            read()
        _check(_kernel().mpqe_ring_sum(
            g.msg.data_ptr(), N, drow, doffs, rt.drow.shape[-1], block, L,
            int(hop == 0), g.out.data_ptr(), stream), "destination sum")
    rgcn_ring_halo_rdma.launches += 1


# ----------------------------------------------------------------------
# The ring
# ----------------------------------------------------------------------
def _check_args(layer, x_padded, edges, n_parts: int):
    if layer.basis is None:
        raise ValueError("rgcn_ring_halo_rdma requires basis decomposition")
    if x_padded.dim() != 2 or x_padded.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"x_padded must be [P * block, d] float32 or "
                         f"bfloat16, got {tuple(x_padded.shape)} "
                         f"{x_padded.dtype}")
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


def _on(t: torch.Tensor, dev, dtype, parts: List[int], n_parts: int):
    """``t``'s rows ``parts`` on ``dev`` as contiguous ``dtype`` (no copy
    where ``t`` already is that and ``parts`` are all of them)."""
    t = t.to(dev, dtype)
    if parts != list(range(n_parts)):
        t = t[torch.tensor(parts, device=dev)]
    return t.contiguous()


def _parts_on(parts: List[int], dev) -> torch.Tensor:
    key = (dev, tuple(parts))
    t = _PARTS.get(key)
    if t is None:
        t = _PARTS[key] = torch.tensor(parts, dtype=torch.int32, device=dev)
    return t


@dataclasses.dataclass
class _Link:
    """This process's end of the ring's process boundaries on the card:
    the comm rows of the card of its first part (made once), the
    previous and next processes, the running hop number and the number
    of each slot's last read.  Where some boundary of the ring lies
    within a node (made collectively): the rows exported, the next
    process's (``ipc.Shared``, opened on the card of this process's last
    part, whose copy stream writes into them, when that process is on
    this node) and the counters on the first part's card (``RECV + k``:
    the previous process's copy into slot k has landed, up to that hop
    number; ``ACK + k``: the next process has read its slot k, up to
    that hop number).  ``net_send`` / ``net_recv``: the next / previous
    process is on another node, and the block crosses by NCCL: ``stream``
    issues the sends and receives on the first part's card (this
    process's NCCL card), ``stage [2, block, K]`` holds the blocks sent
    from each slot, ``sends[k]`` the works of the last send out of
    ``stage[k]``, ``got[k]`` the event of the last receive into slot k,
    ``freed[k]`` the event of slot k's last read."""

    comm_rows: torch.Tensor
    prev: int
    next: int
    next_rows: object = None
    counters: object = None
    net_send: bool = False
    net_recv: bool = False
    stream: Optional[torch.cuda.Stream] = None
    stage: Optional[torch.Tensor] = None
    sends: list = dataclasses.field(default_factory=lambda: [None, None])
    got: list = dataclasses.field(default_factory=lambda: [None, None])
    freed: list = dataclasses.field(default_factory=lambda: [None, None])
    hop: int = 1
    last_read: list = dataclasses.field(default_factory=lambda: [0, 0])


def boundaries_across(world: int) -> List[bool]:
    """For each boundary q of a ring over ``world`` processes (process
    q's last part to process q + 1's first): whether it crosses nodes
    (``multihost.same_node``), and so goes by NCCL, not CUDA IPC."""
    from mpqe_tpu_torch.parallel import multihost

    return [not multihost.same_node(q, (q + 1) % world)
            for q in range(world)]


def _link(devs, first, last, L: int, block: int, K: int) -> _Link:
    """The :class:`_Link` of this shape (collective on first use: every
    process meets the same shapes in the same order); ``first`` / ``last``:
    the cards of this process's first and last parts, ``L`` the parts on
    ``first``.  ``ValueError`` when a boundary between nodes meets a
    group without NCCL, or a process whose first part is not on its NCCL
    card."""
    key = (first, last, L, block, K)
    if key not in _LINKS:
        import torch.distributed as dist

        from mpqe_tpu_torch.parallel import multihost

        w, r = devs.world, devs.rank
        across = boundaries_across(w)
        rows = torch.zeros((2 * L * block + 1, K), device=first)
        link = _Link(comm_rows=rows, prev=(r - 1) % w, next=(r + 1) % w,
                     net_send=across[r], net_recv=across[(r - 1) % w])
        if not all(across):
            link.next_rows = ipc.Shared(rows)
            link.counters = ipc.Counters(first, 4)
        if any(across):
            if not multihost.has_nccl():
                raise ValueError(
                    "rgcn_ring_halo_rdma: a boundary between nodes crosses "
                    f"by NCCL, and this group's backend is "
                    f"{dist.get_backend()}")
            card = multihost.nccl_device()
            if (link.net_send or link.net_recv) and first != card:
                raise ValueError(
                    f"rgcn_ring_halo_rdma between nodes receives into the "
                    f"first part's card, which must be this process's NCCL "
                    f"card {card}: got {first}")
            # the group's communicator made by a collective of every
            # process, so that the batches of a subset may follow
            dist.all_reduce(torch.zeros(1, device=card))
            if link.net_send or link.net_recv:
                link.stream = torch.cuda.Stream(card)
            if link.net_send:
                link.stage = torch.zeros((2, block, K), device=card)
        _LINKS[key] = link
    return _LINKS[key]


def _local_parts(devs) -> List[int]:
    """The parts this process holds; across processes a run of
    consecutive parts, as many in every process (``ValueError``
    otherwise), on one card or several."""
    if not getattr(devs, "spans", False):
        return list(range(len(devs)))
    n, w = len(devs), devs.world
    L = n // w
    if n % w or devs.procs != [p // L for p in range(n)]:
        raise ValueError(f"rgcn_ring_halo_rdma across processes takes "
                         f"runs of consecutive parts, as many in each "
                         f"process: got processes {devs.procs}")
    return devs.local


def _groups(devs, layer, x_padded, edges, block: int, n_rels: int,
            route: Optional[str] = None, rows=None) -> Dict:
    """One :class:`RingGroup` per distinct device of this process's parts,
    buffers allocated on its current stream, slot 0 holding each part's
    own block.  ``route``: None, the plain version's destination layout;
    ``"plain"``, the kernels' route built by :func:`ring_route`;
    ``"kernel"``, by the layout kernels (:func:`_launch_route`), with
    ``out`` left for the first hop to write.  ``rows``: the comm rows of
    the first part's device (a process boundary's exported buffer)
    instead of new ones."""
    by_dev: Dict[torch.device, List[int]] = {}
    for p in _local_parts(devs):
        by_dev.setdefault(devs[p], []).append(p)
    n_parts = len(devs)
    bb, K, N = layer.basis.shape
    groups = {}
    for dev, parts in by_dev.items():
        L = len(parts)
        src, dst, rel, norm = (
            _on(t, dev, dtype, parts, n_parts)
            for t, dtype in zip(edges, (torch.int32,) * 3 + (torch.float32,)))
        comm_rows = (rows if rows is not None and not groups
                     else torch.empty((2 * L * block + 1, K), device=dev))
        comm = comm_rows[:-1].view(2, L, block, K)
        comm[0] = _on(x_padded.view(n_parts, block, K), dev, torch.float32,
                      parts, n_parts)
        kernel = route == "kernel"
        if not kernel:  # the layout kernels zero it
            comm_rows[-1] = 0.0
        g = RingGroup(
            device=dev, parts=parts, comm_rows=comm_rows, comm=comm,
            out=(torch.empty if kernel else torch.zeros)((L, block, N),
                                                          device=dev),
            src=src, dst=dst, rel=rel, norm=norm,
            basis=layer.basis.detach().to(dev, torch.float32).contiguous(),
            coeff=layer.coeff.detach().to(dev, torch.float32).contiguous(),
            parts_t=_parts_on(parts, dev))
        if kernel:
            _launch_route(g, n_parts, block, n_rels)
        elif route == "plain":
            g.route = ring_route(src, dst, rel, norm, g.parts_t, n_parts,
                                 block, n_rels,
                                 route_chunk(src.shape[-1], n_rels))
        else:
            g.perm, g.offs = ring_layout(dst, block)
        if route is not None:
            g.w = torch.empty((n_rels + 1, K, N), device=dev)
            g.msg = torch.empty((g.route.n_chunks * g.route.chunk, N),
                                device=dev)
        groups[dev] = g
    return groups


def _copy_plan(groups, where, n_parts: int):
    """Per receiving device, its copies as ``(sending device, first sending
    index, first receiving index, count)``: runs of parts whose senders
    (part p - 1) sit side by side on one device of this process."""
    plan = {}
    for dev, g in groups.items():
        runs: List[list] = []
        for j, q in enumerate(g.parts):
            if (q - 1) % n_parts not in where:
                continue  # another process's part sends it
            sd, ip = where[(q - 1) % n_parts]
            last = runs[-1] if runs else None
            if (last and last[0] == sd and last[1] + last[3] == ip
                    and last[2] + last[3] == j):
                last[3] += 1
            else:
                runs.append([sd, ip, j, 1])
        plan[dev] = [tuple(r) for r in runs]
    return plan


def _copies(groups, plan, cur: int, nxt: int, dev) -> None:
    """The hop's copies into ``dev``'s parts, on its current stream: part
    p's slot ``cur`` to part p + 1's slot ``nxt``, one slice copy per run
    (a peer copy from another card: ``ipc.copy_between``)."""
    into = groups[dev].comm[nxt]
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    for sd, ip, j, n in plan[dev]:
        src = groups[sd].comm[cur, ip:ip + n]
        if sd == dev:
            into[j:j + n].copy_(src, non_blocking=True)
        else:
            ipc.copy_between(into[j:j + n], src, stream)


def _ring(mesh: Mesh, layer: RGCNLayer, x_padded, edges, n_rels: int,
          axis: str, hop_fn: Callable, streams: bool,
          route: Optional[str] = None) -> torch.Tensor:
    devs = mesh.axis_devices(axis)
    n_parts = len(devs)
    _check_args(layer, x_padded, edges, n_parts)
    block = x_padded.shape[0] // n_parts
    cross = getattr(devs, "spans", False)
    mine = _local_parts(devs)
    first, last = devs[mine[0]], devs[mine[-1]]
    link = None
    if cross and streams:
        link = _link(devs, first, last, sum(devs[p] == first for p in mine),
                     block, x_padded.shape[1])
    groups = _groups(devs, layer, x_padded, edges, block, n_rels, route,
                     rows=None if link is None else link.comm_rows)
    where = {p: (dev, i) for dev in groups
             for i, p in enumerate(groups[dev].parts)}
    plan = _copy_plan(groups, where, n_parts)
    if streams:
        _ring_streams(groups, plan, n_parts, n_rels, hop_fn, link, first,
                      last)
        if link is not None:
            ipc.handshake(link.hop, "K8 ring")
    else:
        if route is not None:
            for g in groups.values():
                g.w = combined_weights(g.basis, g.coeff)
        for s in range(n_parts):
            cur, nxt = s % 2, (s + 1) % 2
            if s + 1 < n_parts:
                for dev in groups:
                    _copies(groups, plan, cur, nxt, dev)
                if cross:
                    _exchange_boundary(groups, devs, first, last, cur, nxt)
            for g in groups.values():
                hop_fn(g, n_parts, s, cur, n_rels)
    if cross:
        return _cross_output(layer, x_padded, groups, devs, block, first)
    if len(groups) == 1:  # the whole ring on one device
        (dev, g), = groups.items()
        L, _, N = g.out.shape
        x = _on(x_padded.view(n_parts, block, -1), dev, torch.float32,
                g.parts, n_parts).view(L * block, -1)
        y = torch.addmm(g.out.view(L * block, N), x,
                        layer.w_self.to(dev, torch.float32)).add_(
            layer.bias.to(dev, torch.float32))
        return y.to(x_padded.device)
    return _self_term(layer, x_padded, groups, n_parts, block,
                      x_padded.device)


def _self_term(layer, x_padded, groups, n_parts: int, block: int, dev):
    """``x @ w_self + agg + bias`` over the whole ring's rows on ``dev``,
    ``agg`` holding the groups' aggregates (zero for parts no group
    holds): one ``addmm``, the call that the whole ring on one device
    makes, so every part's rows are bit-equal to that call's."""
    N = layer.w_self.shape[1]
    agg = torch.zeros((n_parts * block, N), device=dev)
    for g in groups.values():
        for i, p in enumerate(g.parts):
            agg[p * block:(p + 1) * block] = g.out[i]
    x = _on(x_padded.view(n_parts, block, -1), dev, torch.float32,
            list(range(n_parts)), n_parts).view(n_parts * block, -1)
    return torch.addmm(agg, x, layer.w_self.to(dev, torch.float32)).add_(
        layer.bias.to(dev, torch.float32))


def _exchange_boundary(groups, devs, first, last, cur: int,
                       nxt: int) -> None:
    """The plain route's hop across processes: this process's last part's
    slot ``cur`` to the next process's first part's slot ``nxt``, by a
    send to the next process and a receive from the previous one, the
    pairing K8 runs between nodes (gloo for CPU tensors, NCCL for CUDA
    tensors over several nodes, on this process's NCCL card); CUDA
    tensors within one node by ``multihost.exchange`` (CUDA IPC)."""
    import torch.distributed as dist

    from mpqe_tpu_torch.parallel import multihost

    block = groups[last].comm[cur, -1].contiguous()
    prev, nxt_proc = (devs.rank - 1) % devs.world, (devs.rank + 1) % devs.world
    if multihost.transport(block.device) == "ipc":
        got = multihost.exchange([block], last, "K8 ring hop")
        groups[first].comm[nxt, 0] = got[prev][0]
        return
    on = (block.device if block.device.type == "cpu"
          else multihost.nccl_device())
    into = torch.empty_like(block, device=on)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, block.to(on), nxt_proc),
            dist.P2POp(dist.irecv, into, prev)]):
        work.wait()
    groups[first].comm[nxt, 0] = into


def _cross_output(layer, x_padded, groups, devs, block: int, first):
    """Across processes: this process's rows of ``x @ w_self + agg +
    bias`` from :func:`_self_term` over the whole ring's rows on its first
    part's device (the other processes' aggregates zero), then every
    part's rows exchanged, so every process returns the whole output."""
    from mpqe_tpu_torch.parallel import mesh as mesh_lib

    y = _self_term(layer, x_padded, groups, len(devs), block, first)
    outs = [None] * len(devs)
    for g in groups.values():
        for p in g.parts:
            outs[p] = y[p * block:(p + 1) * block]
    return mesh_lib.gather_blocks(outs, x_padded.device, devs)


def _wait_copied(stream, event) -> None:
    """``stream`` waits for the copies into its device's slot (the receive
    semaphore within a process)."""
    stream.wait_event(event)


def _wait_received(link: _Link, stream, slot: int, number: int) -> None:
    """``stream`` waits until the previous process's block for hop
    ``number`` has landed in ``slot`` (the receive semaphore): the
    ``recv`` counter within a node, the receive's event between nodes."""
    if link.net_recv:
        stream.wait_event(link.got[slot])
    else:
        link.counters.wait(stream, RECV + slot, number)


def _remote_copy(link: _Link, g: RingGroup, cur: int, nxt: int,
                 number: int) -> None:
    """On the current (copy) stream of ``g``'s device: this process's last
    part's slot ``cur`` into the next process's first part's slot
    ``nxt``, then that process's ``recv`` counter of the slot set to
    ``number``."""
    stream = torch.cuda.current_stream(g.device)
    block = g.comm.shape[2]
    rows = link.next_rows.mapped(link.next, g.device.index)
    L = (rows.shape[0] - 1) // (2 * block)  # the next process's first card's
    ipc.copy_into(rows.addr(nxt * L * block), g.comm[cur, -1], stream)
    link.counters.write(stream, link.next, RECV + nxt, number)


def _net_hop(link: _Link, g: RingGroup, cur: int, nxt: int) -> None:
    """A boundary between nodes, on the current stream (``link.stream``):
    with ``net_send`` this process's last part's slot ``cur`` (of ``g``)
    copied into ``stage[cur]`` once the send that last read it is done,
    and sent to the next process; with ``net_recv`` the previous
    process's block received into the first part's slot ``nxt``; both in
    one ``batch_isend_irecv``; then the stream waits for the receive and
    ``got[nxt]`` records it."""
    import torch.distributed as dist

    stream = torch.cuda.current_stream(link.stream.device)
    ops = []
    if link.net_send:
        for work in link.sends[cur] or ():
            work.wait()  # the send of two hops ago read stage[cur]
        # a peer copy where the last part lies on another card
        ipc.copy_between(link.stage[cur], g.comm[cur, -1], stream)
        ops.append(dist.P2POp(dist.isend, link.stage[cur], link.next))
    if link.net_recv:
        into = link.comm_rows[:-1].view(2, -1, *g.comm.shape[2:])[nxt, 0]
        ops.append(dist.P2POp(dist.irecv, into, link.prev))
    works = dist.batch_isend_irecv(ops)
    if link.net_send:
        link.sends[cur] = works
    if link.net_recv:
        for work in works:
            work.wait()
        ev = torch.cuda.Event()
        ev.record(stream)
        link.got[nxt] = ev


def _readers(plan, first) -> tuple:
    """From a :func:`_copy_plan`: for each device, the other devices whose
    copy streams read its slots; and whether its copies forward the slot
    of the part on index 0 of ``first`` (the process's first part, which
    past hop 0 holds the previous process's block)."""
    readers = {dev: [r for r in plan if r != dev
                     and any(run[0] == dev for run in plan[r])]
               for dev in plan}
    forwards = {dev: any(sd == first and ip == 0 for sd, ip, _, _ in
                         plan[dev]) for dev in plan}
    return readers, forwards


def _ring_streams(groups, plan, n_parts: int, n_rels: int,
                  hop_fn: Callable, link: Optional[_Link] = None,
                  first=None, last=None) -> None:
    """The ring on CUDA streams: per device the current (compute) stream
    runs the combine and the aggregates, the device's copy stream the
    copies into its parts' slots (a peer copy from another card), events
    order them, within a process and across its cards (``link``'s
    counters across processes of a node, its NCCL sends and receives and
    their events between nodes; ``first`` / ``last``: the cards of this
    process's first and last parts)."""
    compute = {dev: torch.cuda.current_stream(dev) for dev in groups}
    copy = {}
    for dev, g in groups.items():
        copy[dev] = _COPY_STREAMS.get(dev)
        if copy[dev] is None:
            copy[dev] = _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
        g.comm_rows.record_stream(copy[dev])
        with torch.cuda.stream(compute[dev]):
            _launch_combine(g, n_rels)
    readers, forwards = _readers(plan, first)
    alone = len(groups) == 1 and len(groups[first].parts) == 1
    net = link is not None and (link.net_send or link.net_recv)

    def recorded(stream):
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    filled = {dev: recorded(compute[dev]) for dev in groups}  # slot 0 set
    recv: Dict = {}  # (device, slot) -> the copies into it have landed
    ack: Dict = {}  # (device, slot) -> its last reader is done
    sent: Dict = {}  # slot -> the read out of it to the next process done
    base = 0 if link is None else link.hop
    for s in range(n_parts):
        cur, nxt = s % 2, (s + 1) % 2
        if s + 1 < n_parts:
            for dev in groups:
                for sd in {r[0] for r in plan[dev]}:
                    copy[dev].wait_event(filled[sd] if s == 0
                                         else recv[(sd, cur)])
                if s > 0:
                    # the ack token: the receivers' slot nxt is free
                    copy[dev].wait_event(ack[(dev, nxt)])
                    for r in readers[dev]:
                        # and another card's copies of hop s - 1 are done
                        # reading it
                        copy[dev].wait_event(recv[(r, cur)])
                    if link is not None and forwards[dev]:
                        # the previous process's block in the first part's
                        # slot cur, which the copies below read
                        _wait_received(link, copy[dev], cur, base + s)
                    if dev == last and nxt in sent:
                        # and the send to the next process read it
                        copy[dev].wait_event(sent[nxt])
                with torch.cuda.stream(copy[dev]):
                    _copies(groups, plan, cur, nxt, dev)
                recv[(dev, nxt)] = recorded(copy[dev])
            if net:
                stream = link.stream
                if link.net_send:
                    # this process's last part holds its slot cur
                    if s == 0:
                        stream.wait_event(filled[last])
                    elif not alone:
                        stream.wait_event(recv[(last, cur)])
                    elif not link.net_recv:  # the previous process's block
                        _wait_received(link, stream, cur, base + s)
                if link.net_recv:
                    # the first part's slot nxt is free: its last readers
                    # (the previous call's, before filled) are done
                    stream.wait_event(filled[first] if s == 0
                                      else link.freed[nxt])
                with torch.cuda.stream(stream):
                    _net_hop(link, groups[last], cur, nxt)
                if link.net_send:
                    sent[cur] = recorded(stream)
            if link is not None and not link.net_send:
                g, stream = groups[last], copy[last]
                with torch.cuda.stream(stream):
                    # this process's last part holds its slot cur (the
                    # copies above, on this stream, came first)
                    if s == 0:
                        stream.wait_event(filled[last])
                    elif alone:  # ... or the previous process's block
                        _wait_received(link, stream, cur, base + s)
                    # the next process's slot nxt is free
                    link.counters.wait(stream, ACK + nxt,
                                       link.last_read[nxt])
                    _remote_copy(link, g, cur, nxt, base + s + 1)
                sent[cur] = recorded(stream)
        for dev, g in groups.items():
            if s > 0:
                _wait_copied(compute[dev], recv[(dev, cur)])
                if link is not None and dev == first:
                    _wait_received(link, compute[dev], cur, base + s)

            def read(dev=dev, cur=cur, s=s):
                if s + 1 < n_parts - 1:
                    ack[(dev, cur)] = recorded(compute[dev])
                if link is not None and dev == first:
                    if s + 2 < n_parts:
                        # the previous process writes this slot again at
                        # hop s + 2: the copies out of it must be done
                        for d in groups:
                            if forwards[d]:
                                compute[dev].wait_event(recv[(d, nxt)])
                        if alone:
                            compute[dev].wait_event(sent[cur])
                    if link.net_recv:
                        link.freed[cur] = recorded(compute[dev])
                    else:
                        link.counters.write(compute[dev], link.prev,
                                            ACK + cur, base + s)

            with torch.cuda.stream(compute[dev]):
                hop_fn(g, n_parts, s, cur, n_rels, read)
        if link is not None:
            link.last_read[cur] = base + s
    for dev in groups:
        for r in readers[dev]:
            # the slots stay allocated until another card's copies out of
            # them are done (record_stream marks only this card's streams)
            compute[dev].wait_event(recorded(copy[r]))
    if link is not None:
        # the first part's slots are kept for the next call, which writes
        # them on this stream: every copy out of them must be done first
        for dev in groups:
            compute[first].wait_event(recorded(copy[dev]))
        if net:
            # ... and every receive into them, every staging read
            done = recorded(link.stream)
            for dev in groups:
                compute[dev].wait_event(done)
        link.hop = base + n_parts


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
    tensors: per device 6 + 2 P kernel launches a call (five layout
    kernels, the combine; per hop the messages and the destination sum),
    counted in
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
    _kernel()
    # through the module's name, so that a caller can wrap the launch
    return _ring(mesh, layer, x_padded, edges, n_rels, axis,
                 lambda *a: _launch_hop(*a), streams=True, route="kernel")


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


def rgcn_ring_halo_route(
    mesh: Mesh, layer: RGCNLayer, x_padded: torch.Tensor,
    pe_src_local: torch.Tensor, pe_dst_local: torch.Tensor,
    pe_rel: torch.Tensor, pe_norm: torch.Tensor, n_rels: int,
    axis: str = "data", messages: Optional[Callable] = None,
) -> torch.Tensor:
    """The kernels' route in plain PyTorch on any device: the same ring,
    the layouts of :func:`ring_route`, :func:`combined_weights` and each
    hop by :func:`route_hop_reference` with ``messages`` (the tests model
    the kernel's split-TF32 products with it)."""
    def hop(g, n_parts, s, cur, n):
        route_hop_reference(g, n_parts, s, cur, n, messages)

    with torch.no_grad():
        return _ring(mesh, layer, x_padded,
                     (pe_src_local, pe_dst_local, pe_rel, pe_norm), n_rels,
                     axis, hop, streams=False, route="plain")
