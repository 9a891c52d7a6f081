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

* the copies run on one copy stream per device, made once and reused: a
  device's copies for a hop are at most two slice copies (parts whose
  neighbour lives on another device copy alone, ``.to(device)`` semantics
  across cards);
* the hop-(s+1) copy into slot ``(s + 1) % 2`` waits on the event recorded
  once the hop-(s-1) messages have read that slot: the ack token ("your
  slot is free");
* the hop-(s+1) aggregate waits on the copy's event: the receive
  semaphore.

As in the reference, tokens are posted at hops 0 .. P-3 and consumed by
the copies of hops 2 .. P-1 (the waits at hops 1 .. P-2 of the TPU
kernel), so a ring of 2 has none.  The copy of hop s + 1 is issued before
the aggregate of hop s and overlaps it, as the RDMA overlaps it on the TPU.
All buffers are allocated before the first hop on the compute stream and
marked for the copy stream (``record_stream``).  The self-loop and bias,
``x @ w_self + agg + bias``, run outside the kernels, one ``addmm`` per
device.

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

The same schedule runs where the parts sit on different cards, but only a
ring of parts on one card has run it.
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


def _groups(devs, layer, x_padded, edges, block: int, n_rels: int,
            route: Optional[str] = None) -> Dict:
    """One :class:`RingGroup` per distinct device of the axis, buffers
    allocated on its current stream, slot 0 holding each part's own block.
    ``route``: None, the plain version's destination layout; ``"plain"``,
    the kernels' route built by :func:`ring_route`; ``"kernel"``, by the
    layout kernels (:func:`_launch_route`), with ``out`` left for the
    first hop to write."""
    by_dev: Dict[torch.device, List[int]] = {}
    for p, dev in enumerate(devs):
        by_dev.setdefault(dev, []).append(p)
    n_parts = len(devs)
    bb, K, N = layer.basis.shape
    groups = {}
    for dev, parts in by_dev.items():
        L = len(parts)
        src, dst, rel, norm = (
            _on(t, dev, dtype, parts, n_parts)
            for t, dtype in zip(edges, (torch.int32,) * 3 + (torch.float32,)))
        rows = torch.empty((2 * L * block + 1, K), device=dev)
        comm = rows[:-1].view(2, L, block, K)
        comm[0] = _on(x_padded.view(n_parts, block, K), dev, torch.float32,
                      parts, n_parts)
        kernel = route == "kernel"
        if not kernel:  # the layout kernels zero it
            rows[-1] = 0.0
        g = RingGroup(
            device=dev, parts=parts, comm_rows=rows, comm=comm,
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
    (part p - 1) sit side by side on one device."""
    plan = {}
    for dev, g in groups.items():
        runs: List[list] = []
        for j, q in enumerate(g.parts):
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
    """The hop's copies into ``dev``'s parts: part p's slot ``cur`` to
    part p + 1's slot ``nxt``, one slice copy per run."""
    into = groups[dev].comm[nxt]
    for sd, ip, j, n in plan[dev]:
        into[j:j + n].copy_(groups[sd].comm[cur, ip:ip + n],
                            non_blocking=True)


def _ring(mesh: Mesh, layer: RGCNLayer, x_padded, edges, n_rels: int,
          axis: str, hop_fn: Callable, streams: bool,
          route: Optional[str] = None) -> torch.Tensor:
    devs = mesh.axis_devices(axis)
    n_parts = len(devs)
    _check_args(layer, x_padded, edges, n_parts)
    block = x_padded.shape[0] // n_parts
    groups = _groups(devs, layer, x_padded, edges, block, n_rels, route)
    where = {p: (dev, i) for dev in groups
             for i, p in enumerate(groups[dev].parts)}
    plan = _copy_plan(groups, where, n_parts)
    if streams:
        _ring_streams(groups, plan, n_parts, n_rels, hop_fn)
    else:
        if route is not None:
            for g in groups.values():
                g.w = combined_weights(g.basis, g.coeff)
        for s in range(n_parts):
            cur, nxt = s % 2, (s + 1) % 2
            if s + 1 < n_parts:
                for dev in groups:
                    _copies(groups, plan, cur, nxt, dev)
            for g in groups.values():
                hop_fn(g, n_parts, s, cur, n_rels)
    outs = {}
    for dev, g in groups.items():
        L, _, N = g.out.shape
        x = _on(x_padded.view(n_parts, block, -1), dev, torch.float32,
                g.parts, n_parts).view(L * block, -1)
        y = torch.addmm(g.out.view(L * block, N), x,
                        layer.w_self.to(dev)).add_(layer.bias.to(dev))
        if g.parts == list(range(n_parts)):  # the whole ring on one device
            return y.to(x_padded.device)
        for i, p in enumerate(g.parts):
            outs[p] = y[i * block:(i + 1) * block]
    return torch.cat([outs[p].to(x_padded.device) for p in range(n_parts)])


def _ring_streams(groups, plan, n_parts: int, n_rels: int,
                  hop_fn: Callable) -> None:
    """The ring on CUDA streams: per device the current (compute) stream
    runs the combine and the aggregates, the device's copy stream the
    copies, events order them."""
    compute = {dev: torch.cuda.current_stream(dev) for dev in groups}
    copy = {}
    for dev, g in groups.items():
        copy[dev] = _COPY_STREAMS.get(dev)
        if copy[dev] is None:
            copy[dev] = _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
        g.comm_rows.record_stream(copy[dev])
        with torch.cuda.stream(compute[dev]):
            _launch_combine(g, n_rels)

    def recorded(stream):
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    filled = {dev: recorded(compute[dev]) for dev in groups}  # slot 0 set
    recv: Dict = {}  # (device, slot) -> the copies into it have landed
    ack: Dict = {}  # (device, slot) -> its last reader is done
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
                with torch.cuda.stream(copy[dev]):
                    _copies(groups, plan, cur, nxt, dev)
                recv[(dev, nxt)] = recorded(copy[dev])
        for dev, g in groups.items():
            if s > 0:
                compute[dev].wait_event(recv[(dev, cur)])

            def read(dev=dev, cur=cur, s=s):
                if s + 1 < n_parts - 1:
                    ack[(dev, cur)] = recorded(compute[dev])

            with torch.cuda.stream(compute[dev]):
                hop_fn(g, n_parts, s, cur, n_rels, read)


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
