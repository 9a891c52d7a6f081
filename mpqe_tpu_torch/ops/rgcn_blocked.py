"""Blocked bf16 R-GCN layer (counterpart of
``mpqe_tpu/ops/pallas_rgcn_blocked.py``): K6a and K6b as Hopper CUDA
kernels.

Edges are bucketed over (destination node block, source node block)
tiles of ``node_block`` rows, chunk-aligned, destination-major
(:func:`bucket_edges_blocked` for a general graph,
``ops/template_layout.py:template_blocked`` for a template batch):

* K6a :func:`messages_blocked` (reference ``_messages_blocked_pallas``
  :253): the aggregated messages ``[N, d_out]`` f32, basis first, with
  bf16 ``x`` and basis, f32 coefficients, each message rounded to bf16
  before it is summed into its destination in f32;
* K6b :func:`grad_blocked` (reference ``_grad_blocked_pallas`` :384):
  ``dbasis [Bb, d, d_out]`` and ``dcoeff [R, Bb]`` over the whole edge
  list, with ``g`` rounded to bf16 too.

Each wrapper launches ``csrc/rgcn_blocked.cu`` (built at first use) for
CUDA tensors, counted in its ``launches``, and runs its plain PyTorch
version for CPU tensors only.  Both versions take the same operations in
the same order (documented in the CUDA source): products over k
ascending (bf16 x bf16, exact in f32), bases ascending, every message of
a destination row summed in edge order, and the weight gradients summed
in edge order within fixed partitions of edges (:func:`_partition`, a
function of the edge count alone), then over the partitions in order.

:class:`BlockedMessages` is the reference's ``custom_vjp`` (:496-557):
the backward runs K6a once more on the transpose-graph bucketing
(``t_*`` arrays) with the basis transposed, for ``dx``, then K6b.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from mpqe_tpu_torch.ops import cuda_build
from mpqe_tpu_torch.ops import segment as segment_ops
from mpqe_tpu_torch.ops.edge_store import EdgeStore

DEFAULT_NODE_BLOCK = 2048
DEFAULT_CHUNK = 512
PARTITIONS_MAX = 64  # K6b's edge partitions: at most this many, ...
PARTITION_MIN_EDGES = 256  # ... of at least this many edges
EDGE_TILE = 64  # the kernel's edges per tile (csrc/rgcn_blocked.cu QN)

LAYOUT_KEYS = ("src_local", "dst_local", "rel", "norm", "chunk_src_blk",
               "chunk_dst_blk", "chunk_first")


# ----------------------------------------------------------------------
# Host-side bucketing (numpy, the reference's arrays)
# ----------------------------------------------------------------------
def bucket_edges_blocked(store: EdgeStore,
                         node_block: int = DEFAULT_NODE_BLOCK,
                         chunk: int = DEFAULT_CHUNK,
                         max_pad_ratio: float = 4.0,
                         with_transpose: bool = True) -> Dict[str, object]:
    """Bucket edges by (dst // SB, src // SB), pad each bucket to a chunk
    multiple, order buckets dst-major: flat ``src_local``, ``dst_local``,
    ``rel``, ``norm`` ``[n_chunks * chunk]`` and per-chunk
    ``chunk_src_blk``, ``chunk_dst_blk``, ``chunk_first``;
    ``with_transpose`` adds the transpose graph under ``t_`` keys (the
    backward's ``dx`` pass).  Raises ``ValueError`` when the padding would
    exceed ``max_pad_ratio`` times the edges."""
    m = store.pad_mask
    src, dst = store.src[m], store.dst[m]
    rel, norm = store.rel[m], store.norm[m]
    out = _bucket_core(src, dst, rel, norm, store.n_nodes, store.n_rels,
                       node_block, chunk, max_pad_ratio)
    if with_transpose:
        t = _bucket_core(dst, src, rel, norm, store.n_nodes, store.n_rels,
                         node_block, chunk, max_pad_ratio)
        for k in LAYOUT_KEYS:
            out["t_" + k] = t[k]
    return out


def _bucket_core(src, dst, rel, norm, n_nodes: int, n_rels: int,
                 node_block: int, chunk: int,
                 max_pad_ratio: float) -> Dict[str, object]:
    sb = node_block
    n_blocks = -(-n_nodes // sb)
    db = (dst // sb).astype(np.int64)
    sbk = (src // sb).astype(np.int64)
    key = db * n_blocks + sbk
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    counts = np.bincount(key_s, minlength=n_blocks * n_blocks)

    nz = np.nonzero(counts)[0]  # non-empty buckets, dst-major
    if nz.size == 0:
        nz = np.asarray([0], np.int64)
        counts = counts.copy()
        counts[0] = 0
    k_pad = (np.ceil(counts[nz] / chunk) * chunk).astype(np.int64)
    n_real = max(int(src.shape[0]), 1)
    ratio = float(k_pad.sum()) / n_real
    if ratio > max_pad_ratio:
        raise ValueError(
            f"blocked layout would pad {ratio:.1f}x ({int(k_pad.sum())} "
            f"slots for {n_real} edges): block occupancy too sparse for "
            f"node_block={sb}, chunk={chunk} at n_nodes={n_nodes} — use "
            "ops.rgcn_fused.rgcn_sparse_fused, or raise node_block / "
            "max_pad_ratio")
    bucket_base = np.zeros(nz.size, np.int64)
    np.cumsum(k_pad[:-1], out=bucket_base[1:])
    starts = np.zeros(n_blocks * n_blocks, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    rank = np.arange(key_s.size, dtype=np.int64) - starts[key_s]
    bucket_of = np.full(n_blocks * n_blocks, -1, np.int64)
    bucket_of[nz] = np.arange(nz.size)
    flat = bucket_base[bucket_of[key_s]] + rank

    total = int(bucket_base[-1] + k_pad[-1]) if nz.size else 0
    o_src = np.full(total, sb, np.int32)  # padding: outside the block
    o_dst = np.full(total, sb, np.int32)
    o_rel = np.full(total, n_rels, np.int32)
    o_norm = np.zeros(total, np.float32)
    d_blk_e = db[order]
    s_blk_e = sbk[order]
    o_src[flat] = (src[order] - s_blk_e * sb).astype(np.int32)
    o_dst[flat] = (dst[order] - d_blk_e * sb).astype(np.int32)
    o_rel[flat] = rel[order]
    o_norm[flat] = norm[order]

    n_ch_per_bucket = (k_pad // chunk).astype(np.int64)
    c_src = np.repeat(nz % n_blocks, n_ch_per_bucket).astype(np.int32)
    c_dst = np.repeat(nz // n_blocks, n_ch_per_bucket).astype(np.int32)

    # destination blocks without edges still get their (zero) output:
    # one padding chunk each, appended
    present = np.unique(c_dst) if c_dst.size else np.asarray([], np.int32)
    missing = np.setdiff1d(np.arange(n_blocks, dtype=np.int32), present)
    if c_dst.size == 0 and missing.size == 0:
        missing = np.asarray([0], np.int32)
    if missing.size:
        pad_total = missing.size * chunk
        o_src = np.concatenate([o_src, np.full(pad_total, sb, np.int32)])
        o_dst = np.concatenate([o_dst, np.full(pad_total, sb, np.int32)])
        o_rel = np.concatenate([o_rel, np.full(pad_total, n_rels, np.int32)])
        o_norm = np.concatenate([o_norm, np.zeros(pad_total, np.float32)])
        c_src = np.concatenate([c_src, np.zeros(missing.size, np.int32)])
        c_dst = np.concatenate([c_dst, missing])

    c_first = np.ones_like(c_dst)
    c_first[1:] = (c_dst[1:] != c_dst[:-1]).astype(c_dst.dtype)
    return {"src_local": o_src, "dst_local": o_dst, "rel": o_rel,
            "norm": o_norm, "chunk_src_blk": c_src, "chunk_dst_blk": c_dst,
            "chunk_first": c_first, "node_block": sb, "chunk": chunk,
            "n_blocks": n_blocks}


def _first_flags(c_dst: torch.Tensor) -> torch.Tensor:
    """1 on the first chunk of each destination block's run of chunks."""
    one = torch.ones((1,), dtype=torch.int32, device=c_dst.device)
    return torch.cat([one, (c_dst[1:] != c_dst[:-1]).to(torch.int32)])


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))


def layout_on(bucketed: Dict[str, object], dev, prefix: str = ""
              ) -> Dict[str, object]:
    """One direction of a bucketing (``prefix`` ``""`` or ``"t_"``) as
    contiguous tensors on ``dev`` (int32 ids, f32 norm) plus its
    geometry."""
    out = {}
    for k in LAYOUT_KEYS[:-1]:
        t = _tensor(bucketed[prefix + k]).to(dev)
        out[k] = (t.to(torch.float32) if k == "norm"
                  else t.to(torch.int32)).contiguous()
    out["chunk_first"] = _first_flags(out["chunk_dst_blk"])
    for k in ("node_block", "chunk"):
        out[k] = int(bucketed[k])
    return out


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------
def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _global_rows(lay, local: torch.Tensor, blk_key: str, n: int):
    """(row ids clamped into range, validity) of per-edge block-local ids."""
    sb, chunk = lay["node_block"], lay["chunk"]
    blk = torch.repeat_interleave(lay[blk_key].long(), chunk)
    loc = local.long()
    row = blk * sb + loc
    ok = (loc >= 0) & (loc < sb) & (row < n)
    return row.clamp(0, n - 1), ok


def _rows(table: torch.Tensor, lay, local_key: str, blk_key: str):
    """bf16-valued rows of ``table`` selected per edge (0 where the local
    id is padding)."""
    row, ok = _global_rows(lay, lay[local_key], blk_key, table.shape[0])
    return torch.where(ok[:, None], _bf16(table)[row], 0.0)


def _edge_coeff(coeff: torch.Tensor, rel: torch.Tensor, n_rels: int):
    r = rel.long()
    ok = (r >= 0) & (r < n_rels)
    return torch.where(ok[:, None], coeff.to(torch.float32)[
        r.clamp(0, n_rels - 1)], 0.0)


def _ordered_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` summed over k ascending, one rounding per step (products
    of bf16 values are exact in f32: the kernel's fmaf)."""
    y = x.new_zeros((x.shape[0], w.shape[1]))
    for k in range(x.shape[1]):
        y = y + x[:, k:k + 1] * w[k]
    return y


def _basis_first(xs, vb) -> list:
    """Per basis ``h_b = xs @ V_b`` (kernel order)."""
    return [_ordered_matmul(xs, vb[b]) for b in range(vb.shape[0])]


def _ordered_rows_sum(n: int, idx: torch.Tensor, vals: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """``out[idx[e]] += vals[e]`` over the valid edges, each row's terms
    added in edge order (a stable sort by row, then one ``index_add_`` per
    rank within a row: the indices of one call are distinct, so the result
    does not depend on the order of its atomics)."""
    out = vals.new_zeros((n, vals.shape[1]))
    ids = torch.nonzero(valid).squeeze(1)
    if ids.numel() == 0:
        return out
    keys, perm = torch.sort(idx[ids], stable=True)
    pos = torch.arange(keys.numel(), device=keys.device)
    start = torch.ones_like(keys, dtype=torch.bool)
    start[1:] = keys[1:] != keys[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    src = vals[ids[perm]]
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        out.index_add_(0, keys[sel], src[sel])
    return out


def messages_blocked_reference(x, basis, coeff, lay, n_rels: int,
                               n_out: int) -> torch.Tensor:
    """Plain version of K6a: ``[n_out, d_out]`` f32."""
    xs = _rows(x, lay, "src_local", "chunk_src_blk")
    ce = _edge_coeff(coeff, lay["rel"], n_rels)
    vb = _bf16(basis)
    acc = xs.new_zeros((xs.shape[0], vb.shape[2]))
    for b, h in enumerate(_basis_first(xs, vb)):
        acc = acc + ce[:, b:b + 1] * h
    msg = _bf16(acc * lay["norm"][:, None])
    row, ok = _global_rows(lay, lay["dst_local"], "chunk_dst_blk", n_out)
    return _ordered_rows_sum(n_out, row, msg, ok)


def _partition(E: int):
    """(edges per partition, partitions) of K6b's reduction: at most
    ``PARTITIONS_MAX`` partitions of a multiple of the edge tile, at least
    ``PARTITION_MIN_EDGES`` edges each; a function of E alone."""
    per = max(PARTITION_MIN_EDGES, -(-E // PARTITIONS_MAX))
    per = -(-per // EDGE_TILE) * EDGE_TILE
    return per, max(-(-E // per), 1)


def grad_blocked_reference(x, g, basis, coeff, lay, n_rels: int):
    """Plain version of K6b: ``(dbasis [Bb, K, N], dcoeff [n_rels, Bb])``
    f32."""
    xs = _rows(x, lay, "src_local", "chunk_src_blk")
    gd = _rows(g, lay, "dst_local", "chunk_dst_blk")
    gn = gd * lay["norm"][:, None]
    rel = lay["rel"].long()
    ce = _edge_coeff(coeff, rel, n_rels)
    vb = _bf16(basis)
    E, bb = xs.shape[0], vb.shape[0]
    K, N = vb.shape[1], vb.shape[2]
    s = xs.new_zeros((E, bb))
    for b, h in enumerate(_basis_first(xs, vb)):
        prod = h * gn
        acc = xs.new_zeros((E,))
        for o in range(N):
            acc = acc + prod[:, o]
        s[:, b] = _bf16(acc)

    P, n_part = _partition(E)
    pad = n_part * P - E

    def parts(t, fill=0):
        return torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 1) + (0, pad), value=fill).view(
            n_part, P, *t.shape[1:])

    xs_p, gn_p, ce_p, s_p = parts(xs), parts(gn), parts(ce), parts(s)
    rel_p = parts(rel, -1)
    pidx = torch.arange(n_part, device=xs.device)
    dc = xs.new_zeros((n_part, n_rels, bb))
    db = xs.new_zeros((n_part, bb, K, N))
    for i in range(P):
        r = rel_p[:, i]
        ok = ((r >= 0) & (r < n_rels))[:, None]
        rc = r.clamp(0, n_rels - 1)
        cur = dc[pidx, rc]
        dc[pidx, rc] = torch.where(ok, cur + s_p[:, i], cur)
        rhs = _bf16(ce_p[:, i, :, None] * gn_p[:, i, None, :])  # [p, Bb, N]
        db = db + xs_p[:, i, None, :, None] * rhs[:, :, None, :]
    dbasis, dcoeff = torch.zeros_like(db[0]), torch.zeros_like(dc[0])
    for p in range(n_part):
        dbasis = dbasis + db[p]
        dcoeff = dcoeff + dc[p]
    return dbasis, dcoeff


# ----------------------------------------------------------------------
# The kernels
# ----------------------------------------------------------------------
_KERNEL = None


def _kernel():
    """The built K6 library, its entry points' argument types set."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("rgcn_blocked", ["rgcn_blocked.cu"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mpqe_rgcn_blocked_forward.argtypes = [
            p, i, p, p, i, i, i, i, p, p, p, p, p, p, p, p, i, i, i, p, p]
        lib.mpqe_rgcn_blocked_forward.restype = i
        lib.mpqe_rgcn_blocked_grad.argtypes = [
            p, p, i, p, p, i, i, i, i, p, p, p, p, p, p, ll, i, i, ll, i, p,
            p, p, p]
        lib.mpqe_rgcn_blocked_grad.restype = i
        lib.mpqe_rgcn_blocked_smem_bytes.argtypes = [i, i, i, i]
        lib.mpqe_rgcn_blocked_smem_bytes.restype = ll
        lib.mpqe_rgcn_blocked_max_smem.argtypes = [i]
        lib.mpqe_rgcn_blocked_max_smem.restype = ll
        _KERNEL = lib
    return _KERNEL


def _check_cuda(x, basis, coeff, lay, n_rels: int, n_rows: int,
                extra=()):
    """Device, type, shape and geometry checks; returns the library."""
    dev = x.device
    bb, K, N = basis.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x must be [rows, {K}]")
    if tuple(coeff.shape) != (n_rels, bb):
        raise ValueError(f"coeff must be [{n_rels}, {bb}]")
    E = lay["src_local"].shape[0]
    chunk, sb = lay["chunk"], lay["node_block"]
    n_chunks = lay["chunk_dst_blk"].shape[0]
    if E == 0 or E != n_chunks * chunk or E >= 2 ** 31:
        raise ValueError(f"{E} edges do not fill {n_chunks} chunks of "
                         f"{chunk} (or exceed int32)")
    if n_rows == 0 or -(-n_rows // sb) > 65535:
        raise ValueError(f"{n_rows} rows in blocks of {sb}: out of range")
    for k in LAYOUT_KEYS:
        t = lay[k]
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"layout {k} must be contiguous on {dev}")
        want = n_chunks if k.startswith("chunk_") else E
        if t.shape != (want,):
            raise ValueError(f"layout {k} must have {want} entries")
    for t in (basis, coeff, *extra):
        if t.device != dev:
            raise ValueError(f"operand on {t.device}, x on {dev}")
    lib = _kernel()
    with torch.cuda.device(dev):
        have = lib.mpqe_rgcn_blocked_max_smem(torch.cuda.current_device())
    if lib.mpqe_rgcn_blocked_smem_bytes(K, N, bb, n_rels) > have:
        raise ValueError(f"widths K={K}, N={N}, {bb} bases, {n_rels} "
                         f"relations need more shared memory per block "
                         f"than the card's {have} bytes")
    return lib


def _dst_block_ranges(lay, n_blocks: int):
    """Per destination block its run of chunks ``[lo, hi)`` (the run's
    first chunk by ``chunk_first``; blocks without chunks get an empty
    range)."""
    c_dst = lay["chunk_dst_blk"].long()
    n_chunks = c_dst.shape[0]
    idx = torch.arange(n_chunks, device=c_dst.device)
    first = torch.where(lay["chunk_first"] == 1, idx, n_chunks)
    lo = torch.full((n_blocks,), n_chunks, dtype=torch.long,
                    device=c_dst.device).scatter_reduce(0, c_dst, first,
                                                        "amin")
    hi = torch.zeros((n_blocks,), dtype=torch.long,
                     device=c_dst.device).scatter_reduce(0, c_dst, idx + 1,
                                                         "amax")
    return lo.to(torch.int32), hi.to(torch.int32)


def _lay_ptrs(lay):
    return [lay[k].data_ptr() for k in LAYOUT_KEYS[:-1]]


def messages_blocked(x: torch.Tensor, basis: torch.Tensor,
                     coeff: torch.Tensor, lay: Dict[str, object],
                     n_rels: int) -> torch.Tensor:
    """K6a: aggregated messages ``[N, d_out]`` f32 of ``x [N, d]`` over the
    layout ``lay`` (:func:`layout_on`), no self-loop or bias.  CUDA
    tensors: the kernel, counted in ``messages_blocked.launches``; CPU
    tensors: the plain version."""
    n = x.shape[0]
    if x.device.type == "cpu":
        return messages_blocked_reference(x, basis, coeff, lay, n_rels, n)
    if x.device.type != "cuda":
        raise ValueError(f"messages_blocked: unsupported device {x.device}")
    lib = _check_cuda(x, basis, coeff, lay, n_rels, n)
    bb, K, N = basis.shape
    sb = lay["node_block"]
    n_blocks = -(-n // sb)
    lo, hi = _dst_block_ranges(lay, n_blocks)
    xb = x.to(torch.bfloat16).contiguous()
    vb = basis.to(torch.bfloat16).contiguous()
    cf = coeff.to(torch.float32).contiguous()
    out = torch.empty((n, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mpqe_rgcn_blocked_forward(
            xb.data_ptr(), n, vb.data_ptr(), cf.data_ptr(), n_rels, bb, K, N,
            *_lay_ptrs(lay), lo.data_ptr(), hi.data_ptr(), n_blocks,
            lay["chunk"], sb, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6a kernel launch failed: cudaError {err}")
    messages_blocked.launches += 1
    return out


messages_blocked.launches = 0


def grad_blocked(x: torch.Tensor, g: torch.Tensor, basis: torch.Tensor,
                 coeff: torch.Tensor, lay: Dict[str, object], n_rels: int):
    """K6b: ``(dbasis [Bb, d, d_out], dcoeff [R, Bb])`` f32 of K6a for the
    cotangent ``g [N, d_out]`` over the forward layout.  CUDA tensors: the
    kernel's passes, counted once in ``grad_blocked.launches``; CPU
    tensors: the plain version."""
    if x.device.type == "cpu":
        return grad_blocked_reference(x, g, basis, coeff, lay, n_rels)
    if x.device.type != "cuda":
        raise ValueError(f"grad_blocked: unsupported device {x.device}")
    n = x.shape[0]
    bb, K, N = basis.shape
    if tuple(g.shape) != (n, N):
        raise ValueError(f"g must be [{n}, {N}]")
    lib = _check_cuda(x, basis, coeff, lay, n_rels, n, (g,))
    E = lay["src_local"].shape[0]
    P, n_part = _partition(E)
    T = bb * K * N + n_rels * bb
    dev = x.device
    xb = x.to(torch.bfloat16).contiguous()
    gb = g.to(torch.bfloat16).contiguous()
    vb = basis.to(torch.bfloat16).contiguous()
    cf = coeff.to(torch.float32).contiguous()
    s = torch.empty((E, bb), dtype=torch.float32, device=dev)
    partial = torch.empty((n_part, T), dtype=torch.float32, device=dev)
    out = torch.empty((T,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mpqe_rgcn_blocked_grad(
            xb.data_ptr(), gb.data_ptr(), n, vb.data_ptr(), cf.data_ptr(),
            n_rels, bb, K, N, *_lay_ptrs(lay), E, lay["chunk"],
            lay["node_block"], P, n_part, s.data_ptr(), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6b kernel launch failed: cudaError {err}")
    grad_blocked.launches += 1
    return out[:bb * K * N].view(bb, K, N), out[bb * K * N:].view(n_rels, bb)


grad_blocked.launches = 0


# ----------------------------------------------------------------------
# Differentiable layer
# ----------------------------------------------------------------------
def _messages_xla_twin(x, basis, coeff, src_l, dst_l, rel, norm, c_src,
                       c_dst, n_rels: int, sb: int, chunk: int):
    """The same math in f32 composable ops (the oracle; it materializes
    ``[E, Bb, d_out]``, so small sizes only)."""
    n = x.shape[0]
    src = src_l.long() + torch.repeat_interleave(c_src.long(), chunk) * sb
    dst = dst_l.long() + torch.repeat_interleave(c_dst.long(), chunk) * sb
    rel_c = rel.long().clamp(0, n_rels - 1)
    valid = (rel < n_rels).to(torch.float32)
    ce = coeff[rel_c] * valid[:, None]
    h_b = torch.einsum("nd,bdo->nbo", x, basis)
    msg = torch.einsum("eb,ebo->eo", ce, h_b[src.clamp(0, n - 1)])
    msg = msg * norm[:, None]
    return segment_ops.segment_sum(msg, dst, n)


class BlockedMessages(torch.autograd.Function):
    """Aggregated messages through K6a; backward K6a on the transpose
    layout (``dx``) and K6b (``dbasis``, ``dcoeff``).  ``apply(x, basis,
    coeff, fwd_layout, t_layout, n_rels)`` with layouts from
    :func:`layout_on`."""

    @staticmethod
    def forward(ctx, x, basis, coeff, lay, t_lay, n_rels):
        ctx.meta = (lay, t_lay, n_rels)
        ctx.save_for_backward(x, basis, coeff)
        return messages_blocked(x, basis, coeff, lay, n_rels)

    @staticmethod
    def backward(ctx, g):
        lay, t_lay, n_rels = ctx.meta
        x, basis, coeff = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dx = messages_blocked(g, basis.transpose(1, 2), coeff, t_lay,
                              n_rels)
        dbasis, dcoeff = grad_blocked(x, g, basis, coeff, lay, n_rels)
        return (dx.to(x.dtype), dbasis.to(basis.dtype),
                dcoeff.to(coeff.dtype), None, None, None)


def rgcn_sparse_blocked(x: torch.Tensor, layer,
                        bucketed: Dict[str, object],
                        n_rels: int) -> torch.Tensor:
    """Full R-GCN layer through the blocked bf16 kernels (basis layers).
    ``bucketed`` comes from :func:`bucket_edges_blocked` (numpy) or
    ``template_blocked`` (tensors), transpose arrays included.  Expect
    ~1e-2 relative deviation from the f32 paths (bf16 products)."""
    if layer.basis is None:
        raise ValueError(
            "rgcn_sparse_blocked requires basis decomposition; use "
            "rgcn_sparse_fused for full-weight models")
    if "t_src_local" not in bucketed:
        raise ValueError(
            "bucketed dict lacks the transpose layout needed by the "
            "backward; re-run bucket_edges_blocked(with_transpose=True)")
    lay = layout_on(bucketed, x.device)
    t_lay = layout_on(bucketed, x.device, "t_")
    agg = BlockedMessages.apply(x, layer.basis, layer.coeff, lay, t_lay,
                                n_rels)
    return x @ layer.w_self + agg + layer.bias
