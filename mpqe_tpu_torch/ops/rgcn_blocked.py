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
version for CPU tensors only.  The plain versions define the function:
products over k ascending (bf16 x bf16, exact in f32), bases ascending,
every message of a destination row summed in edge order, and the weight
gradients summed in edge order within fixed partitions of edges
(:func:`_partition`, a function of the edge count alone), then over the
partitions in order.  The kernels keep every one of those orders except
the K-deep sums inside the products, which the tensor cores take in
their own; :func:`blocked_error_bound`, :func:`grad_s_bound` and the
gates :func:`k6a_gate` / :func:`k6b_gate` state what that may change.
:func:`layout_on` builds the kernels' edge lists (padding dropped, a
destination CSR for K6a) once per layout.

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
EDGE_TILE = 64  # K6b's edges per tile (csrc/rgcn_blocked.cu GT)
K6A_EDGES_PER_BLOCK = 2048  # edges per K6a block (whole rows), at most,
K6A_MIN_BLOCKS = 33  # ... and fewer while a layout gives fewer blocks
# than this (x 4 column tiles at d = 128: one per SM of an H100), down
# to one 128-edge tile a block

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
    contiguous tensors on ``dev`` (int32 ids, f32 norm), its geometry, and
    the kernels' edge lists (:func:`_edge_lists`; K6b's only for the
    forward direction ``""``, the one K6b reads), built here once per
    layout."""
    out = {}
    for k in LAYOUT_KEYS[:-1]:
        t = _tensor(bucketed[prefix + k]).to(dev)
        out[k] = (t.to(torch.float32) if k == "norm"
                  else t.to(torch.int32)).contiguous()
    out["chunk_first"] = _first_flags(out["chunk_dst_blk"])
    for k in ("node_block", "chunk"):
        out[k] = int(bucketed[k])
    n_blocks = bucketed.get("n_blocks")
    if n_blocks is None:  # a hand-made layout: its largest block id
        n_blocks = 1 + int(torch.maximum(
            out["chunk_src_blk"].max(), out["chunk_dst_blk"].max()))
    out.update(_edge_lists(out, int(n_blocks), prefix == ""))
    return out


def layouts_on(bucketed: Dict[str, object], dev) -> tuple:
    """``(forward layout, transpose layout)`` of a bucketing on ``dev``:
    what :func:`rgcn_sparse_blocked` takes in place of the bucketing, so
    that an encode builds them once for all its layers."""
    return layout_on(bucketed, dev), layout_on(bucketed, dev, "t_")


def _edge_lists(lay, n_blocks: int, grad: bool) -> Dict[str, object]:
    """The real edges of a layout, as the kernels walk them.

    An edge is padding when its source or destination local id lies
    outside its block (``_global_rows``): the plain versions add nothing
    for it, or an exact 0, so the kernels skip it.  A real edge with an
    out-of-range ``rel`` or a zero norm stays (its message is 0 only for
    finite inputs).  Rows are counted up to ``n_cap = n_blocks * sb``; a
    call with fewer rows treats the rest as the plain version does.  Each
    list keeps the layout's length, the real edges first and the padding
    after them, so that nothing here waits for the device (no host sync),
    and an edge is one int32 row ``(src, dst, rel, norm's bits)`` of global
    rows: the lists are built once per batch on the training path, in few
    operations.

    * K6a's destination CSR: the edges sorted stably by destination (so
      each row's edges keep edge order, the order in which
      :func:`_ordered_rows_sum` adds them): ``csr [E, 4]``, their layout
      positions ``csr_pos``, ``csr_ptr
      [n_cap + 1]`` and ``cta_rows``, the first row of each K6a block:
      block i owns the rows ``[cta_rows[i], cta_rows[i + 1])``, about
      ``K6A_EDGES_PER_BLOCK`` edges (fewer in a small layout,
      ``K6A_MIN_BLOCKS``), every row in exactly one block.
    * With ``grad`` (the forward direction, which K6b reads), K6b's list in
      edge order: ``edges [E, 4]``, ``edge_pos`` (each edge's position in
      the layout) and ``part_ptr [n_part + 1]``, the first listed edge of
      each of :func:`_partition`'s partitions of the layout's positions
      (``part_ptr[-1]`` is the number of real edges), the mask ``real``;
      and its dcoeff runs (:func:`_dc_runs`):
      the edges sorted stably by (partition, relation), so each run of one
      relation within one partition keeps edge order: ``dc_pos`` (layout
      positions) and ``dc [E, 4]`` (partition, relation or -1 at padding,
      one past the run's last entry, 0)."""
    sb = lay["node_block"]
    n_cap = n_blocks * sb
    E = lay["src_local"].shape[0]
    dev = lay["src_local"].device
    src, dst, ok = _real_edges(lay, n_cap)
    packed = torch.stack([src.to(torch.int32), dst.to(torch.int32),
                          lay["rel"], lay["norm"].view(torch.int32)], 1)
    big = torch.iinfo(torch.int64).max
    # K6a: by destination, padding last; each block's whole rows
    dkey, order = torch.sort(torch.where(ok, dst, n_cap), stable=True)
    ptr = torch.searchsorted(dkey, torch.arange(n_cap + 1, device=dev))
    per = min(K6A_EDGES_PER_BLOCK, max(128, -(-E // K6A_MIN_BLOCKS)))
    starts = torch.arange(max(1, -(-E // per)), device=dev) * per
    cta_rows = torch.cat([torch.searchsorted(ptr, starts).clamp_(max=n_cap),
                          torch.full((1,), n_cap, device=dev)])
    out = {"csr": packed[order], "csr_pos": order.to(torch.int32),
           "csr_ptr": ptr.to(torch.int32),
           "cta_rows": cta_rows.to(torch.int32), "n_cap": n_cap}
    if not grad:
        return out
    P, n_part = _partition(E)
    # K6b: real edges first, in edge order
    pkey, order = torch.sort(
        torch.where(ok, torch.arange(E, device=dev), big), stable=True)
    bounds = torch.arange(n_part + 1, device=dev) * P
    out.update(edges=packed[order], edge_pos=order.to(torch.int32),
               part_ptr=torch.searchsorted(pkey, bounds).to(torch.int32),
               real=ok)
    out.update(_dc_runs(ok, lay["rel"]))
    return out


def _dc_runs(real: torch.Tensor, rel: torch.Tensor) -> Dict[str, object]:
    """K6b's dcoeff runs: the edges sorted stably by (partition, relation),
    padding last (see :func:`_edge_lists`)."""
    E = real.shape[0]
    P, _ = _partition(E)
    iota = torch.arange(E, device=real.device)
    rel = rel.long()
    rkey = torch.where(real, (iota // P) * (1 << 32) + (rel + (1 << 31)),
                       torch.iinfo(torch.int64).max)
    rkey, order = torch.sort(rkey, stable=True)
    end = torch.searchsorted(rkey, rkey, right=True)
    return {"dc_pos": order.to(torch.int32), "dc": torch.stack(
        [order // P, torch.where(real, rel, -1)[order], end,
         torch.zeros_like(end)], 1).to(torch.int32)}


def relabeled(lay: Dict[str, object], rel: torch.Tensor,
              norm: torch.Tensor) -> Dict[str, object]:
    """What :func:`layout_on` builds for ``lay``'s layout with each edge's
    relation and norm replaced by ``rel`` / ``norm`` ``[E]`` (by layout
    position), from ``lay``'s edge orders, which do not depend on them: a
    few operations where ``layout_on`` sorts (a template batch's layout
    changes only in them from step to step)."""
    rel = rel.to(torch.int32).contiguous()
    norm = norm.to(torch.float32).contiguous()
    bits = norm.view(torch.int32)

    def rows(packed, pos):
        pos = pos.long()
        return torch.stack([packed[:, 0], packed[:, 1], rel[pos], bits[pos]],
                           1)

    out = dict(lay, rel=rel, norm=norm, csr=rows(lay["csr"], lay["csr_pos"]))
    if "edges" in lay:
        out["edges"] = rows(lay["edges"], lay["edge_pos"])
        out.update(_dc_runs(lay["real"], rel))
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


def _real_edges(lay, n: int):
    """(global src rows, global dst rows, real): an edge is real when both
    its local ids lie inside their blocks and both rows below ``n``."""
    src, s_ok = _global_rows(lay, lay["src_local"], "chunk_src_blk", n)
    dst, d_ok = _global_rows(lay, lay["dst_local"], "chunk_dst_blk", n)
    return src, dst, s_ok & d_ok


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


def _edge_messages(x, basis, coeff, lay, n_rels: int) -> torch.Tensor:
    """Plain K6a's per-edge messages ``msg = bf16(acc * norm)``,
    ``[E, d_out]`` f32, every edge of the layout (padding included)."""
    xs = _rows(x, lay, "src_local", "chunk_src_blk")
    ce = _edge_coeff(coeff, lay["rel"], n_rels)
    vb = _bf16(basis)
    acc = xs.new_zeros((xs.shape[0], vb.shape[2]))
    for b, h in enumerate(_basis_first(xs, vb)):
        acc = acc + ce[:, b:b + 1] * h
    return _bf16(acc * lay["norm"][:, None])


def _dst_sum(msg, lay, n_out: int) -> torch.Tensor:
    row, ok = _global_rows(lay, lay["dst_local"], "chunk_dst_blk", n_out)
    return _ordered_rows_sum(n_out, row, msg, ok)


def messages_blocked_reference(x, basis, coeff, lay, n_rels: int,
                               n_out: int) -> torch.Tensor:
    """Plain version of K6a: ``[n_out, d_out]`` f32."""
    return _dst_sum(_edge_messages(x, basis, coeff, lay, n_rels), lay,
                    n_out)


def _partition(E: int):
    """(edges per partition, partitions) of K6b's reduction: at most
    ``PARTITIONS_MAX`` partitions of a multiple of the edge tile, at least
    ``PARTITION_MIN_EDGES`` edges each; a function of E alone."""
    per = max(PARTITION_MIN_EDGES, -(-E // PARTITIONS_MAX))
    per = -(-per // EDGE_TILE) * EDGE_TILE
    return per, max(-(-E // per), 1)


def _parts(t: torch.Tensor, fill=0):
    """``t [E, ...]`` padded to whole partitions: ``[n_part, P, ...]``."""
    P, n_part = _partition(t.shape[0])
    pad = n_part * P - t.shape[0]
    return torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 1) + (0, pad), value=fill).view(
        n_part, P, *t.shape[1:])


def _ordered_dcoeff(s: torch.Tensor, rel: torch.Tensor,
                    n_rels: int) -> torch.Tensor:
    """``dcoeff [n_rels, Bb]``: ``s [E, Bb]`` summed per relation, edges
    in order within each partition, then the partitions in order (edges
    with ``rel`` out of range add nothing)."""
    s_p, rel_p = _parts(s), _parts(rel.long(), -1)
    n_part, P = rel_p.shape
    pidx = torch.arange(n_part, device=s.device)
    dc = s.new_zeros((n_part, n_rels, s.shape[1]))
    for i in range(P):
        r = rel_p[:, i]
        ok = ((r >= 0) & (r < n_rels))[:, None]
        rc = r.clamp(0, n_rels - 1)
        cur = dc[pidx, rc]
        dc[pidx, rc] = torch.where(ok, cur + s_p[:, i], cur)
    dcoeff = torch.zeros_like(dc[0])
    for p in range(n_part):
        dcoeff = dcoeff + dc[p]
    return dcoeff


def grad_blocked_reference_parts(x, g, basis, coeff, lay, n_rels: int):
    """Plain version of K6b with its per-edge terms: ``(dbasis [Bb, K,
    N], dcoeff [n_rels, Bb], s [E, Bb])``, ``s`` the bf16-rounded
    ``s_eb = sum_o (h_b * gn)_o`` of every edge of the layout."""
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

    xs_p, gn_p, ce_p = _parts(xs), _parts(gn), _parts(ce)
    n_part, P = xs_p.shape[:2]
    db = xs.new_zeros((n_part, bb, K, N))
    for i in range(P):
        rhs = _bf16(ce_p[:, i, :, None] * gn_p[:, i, None, :])  # [p, Bb, N]
        db = db + xs_p[:, i, None, :, None] * rhs[:, :, None, :]
    dbasis = torch.zeros_like(db[0])
    for p in range(n_part):
        dbasis = dbasis + db[p]
    return dbasis, _ordered_dcoeff(s, rel, n_rels), s


def grad_blocked_reference(x, g, basis, coeff, lay, n_rels: int):
    """Plain version of K6b: ``(dbasis [Bb, K, N], dcoeff [n_rels, Bb])``
    f32."""
    return grad_blocked_reference_parts(x, g, basis, coeff, lay,
                                        n_rels)[:2]


# ----------------------------------------------------------------------
# What the tensor cores may change, and the gates that hold them to it
# ----------------------------------------------------------------------
# The kernels take the products xs @ V_b (and xs^T @ rhs) on the tensor
# cores, which sum the K bf16 products of an output in their own order
# and precision; the plain versions sum them one by one, k ascending.
# Every other operation (the basis sum, norm, bf16 roundings, the
# destination sums and the partitions) runs in the plain versions' order.
TOL_PLAIN = 1e-4  # max|diff| / max|ref| where no bf16 rounding follows
FLIP_SHARE_MAX = 0.01  # K6b: share of s_eb one bf16 step off the plain


def blocked_error_bound(x, basis, coeff, lay, n_rels: int, n_out: int,
                        msg: torch.Tensor = None) -> torch.Tensor:
    """Per-element bound ``[n_out, d_out]`` on ``|K6a - plain K6a|``::

        2^-6 * M + 2^-14 * A,
        M[row, o] = sum_{e -> row} |msg_e[o]|,
        A[row, o] = sum_{e -> row} |norm_e| sum_b |ce_eb| (|xs_e| @ |V_b|)[o]

    ``msg`` are the plain version's rounded messages (computed here when
    not given).  Derivation: the kernel's ``h_b`` is the same sum of K
    exact bf16 products in another order; each order is within
    ``(K - 1) 2^-24 (|xs| @ |V_b|)`` of the exact sum, so the two differ by
    at most ``2 (K - 1) 2^-24`` of it, and ``2^-14 = 1024 * 2^-24`` is about
    4x that at K = 128.  The basis sum and the norm repeat the same
    operations on those inputs, so before the bf16 rounding the two
    messages differ by at most ``2^-14 A_e`` (their own roundings, 2 Bb
    steps of 2^-24, fit in the same margin).  The rounding then adds at
    most one bf16 step, ``<= 2^-7 |msg_e|``; ``2^-6 M`` covers it twice,
    which also covers the f32 destination sum, taken in the same edge
    order (each of a row's adds re-rounds by at most 2^-24 of the running
    sum).  Runs on any device, one basis at a time (no ``[E, Bb, d_out]``
    tensor)."""
    if msg is None:
        msg = _edge_messages(x, basis, coeff, lay, n_rels)
    xs = _rows(x, lay, "src_local", "chunk_src_blk").abs()
    vb = _bf16(basis).abs()
    ce = _edge_coeff(coeff, lay["rel"], n_rels).abs()
    a = xs.new_zeros(msg.shape)
    for b in range(vb.shape[0]):
        a += ce[:, b:b + 1] * (xs @ vb[b])
    a *= lay["norm"].abs()[:, None]
    row, ok = _global_rows(lay, lay["dst_local"], "chunk_dst_blk", n_out)
    m = msg.abs()
    out = msg.new_zeros((n_out, msg.shape[1]))
    w = torch.where(ok[:, None], 2.0 ** -6 * m + 2.0 ** -14 * a, 0.0)
    return out.index_add_(0, row, w)


def grad_s_bound(x, g, basis, lay) -> torch.Tensor:
    """``[E, Bb]`` bound on how far the kernel's ``s_eb`` may lie from the
    plain one before the bf16 rounding: ``2^-14 T_eb`` with ``T_eb =
    sum_o (|xs_e| @ |V_b|)_o |gn_eo|``.  Derivation as in
    :func:`blocked_error_bound`: each ``h_b`` element moves by at most
    ``2 (K - 1) 2^-24`` of ``(|xs| @ |V_b|)``, and the sum over o, taken
    in the kernel's fixed order, by at most ``2 (N - 1) 2^-24`` of ``T``;
    ``2^-14 T`` is about 2x their sum at K = N = 128.  Where ``s_eb``
    cancels (``|s_eb|`` far below ``T_eb``) this, not one bf16 step, is
    what the two may differ by."""
    xs = _rows(x, lay, "src_local", "chunk_src_blk").abs()
    vb = _bf16(basis).abs()
    gn = (_rows(g, lay, "dst_local", "chunk_dst_blk")
          * lay["norm"][:, None]).abs()
    t = xs.new_zeros((xs.shape[0], vb.shape[0]))
    for b in range(vb.shape[0]):
        t[:, b] = ((xs @ vb[b]) * gn).sum(1)
    return 2.0 ** -14 * t


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def k6a_gate(got: torch.Tensor, want: torch.Tensor,
             bound: torch.Tensor) -> dict:
    """K6a held to the plain version under :func:`blocked_error_bound`:
    ``ok`` when every element is within its bound; also the largest
    diff / bound, the share of elements that differ and max|diff| /
    max|ref|."""
    diff = (got - want).abs()
    ratio = torch.where(diff > 0, diff / bound, torch.zeros_like(diff))
    worst = float(ratio.max()) if ratio.numel() else 0.0
    return {"ok": bool((diff <= bound).all()), "bound_ratio": worst,
            "flip_share": float((diff > 0).float().mean()),
            "rel_err": _rel_err(got, want)}


def _bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 values lie between ``a`` and ``b`` (bf16-valued f32),
    counted on the monotone integer line of the bf16 bit patterns."""
    def line(t):
        i = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (line(a) - line(b)).abs()


def k6b_gate(got, want, s_bound: torch.Tensor, rel: torch.Tensor,
             n_rels: int) -> dict:
    """K6b held to the plain version.  ``got`` and ``want`` are ``(dbasis,
    dcoeff, s)`` (:func:`grad_blocked_parts`,
    :func:`grad_blocked_reference_parts`).

    * ``dbasis`` within ``TOL_PLAIN``: ``rhs`` is rounded per element as
      in the plain version and no bf16 rounding follows the sums;
    * each ``s_eb`` equal to the plain one or its bf16 neighbour, or,
      where the sum cancels, within ``s_bound`` (:func:`grad_s_bound`);
      at most ``FLIP_SHARE_MAX`` of them off the plain value;
    * ``dcoeff`` within ``TOL_PLAIN`` of the plain-ordered sum of the
      kernel's own ``s_eb``."""
    db_err = _rel_err(got[0], want[0])
    steps = _bf16_steps(got[2], want[2])
    far = (steps > 1) & ((got[2] - want[2]).abs() > s_bound)
    flip = float((steps > 0).float().mean())
    dc_err = _rel_err(got[1], _ordered_dcoeff(got[2], rel, n_rels))
    s_ok = not bool(far.any()) and flip <= FLIP_SHARE_MAX
    return {"ok": db_err <= TOL_PLAIN and s_ok and dc_err <= TOL_PLAIN,
            "dbasis_ok": db_err <= TOL_PLAIN, "dcoeff_ok": s_ok and
            dc_err <= TOL_PLAIN, "dbasis_err": db_err,
            "s_flip_share": flip, "s_beyond_neighbour": int(
                (steps > 1).sum()), "dcoeff_err": dc_err}


# ----------------------------------------------------------------------
# The kernels
# ----------------------------------------------------------------------
_KERNEL = None
GRAD_TILE = 128  # K6b's dbasis tiles are GRAD_TILE x GRAD_TILE (GW)


def _kernel():
    """The built K6 library, its entry points' argument types set."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("rgcn_blocked", ["rgcn_blocked.cu"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mpqe_rgcn_blocked_forward.argtypes = [
            p, i, p, p, i, i, i, i, i, p, p, p, i, p, p]
        lib.mpqe_rgcn_blocked_forward.restype = i
        lib.mpqe_rgcn_blocked_grad.argtypes = [
            p, p, i, p, p, i, i, i, i, p, p, p, i, p, p, i, p, p, p, p, p]
        lib.mpqe_rgcn_blocked_grad.restype = i
        _KERNEL = lib
    return _KERNEL


CSR_KEYS = ("csr", "csr_ptr", "cta_rows")  # K6a's edge lists
GRAD_KEYS = ("edges", "edge_pos", "part_ptr", "dc_pos", "dc")  # K6b's


def _check_cuda(x, basis, coeff, lay, n_rels: int, n_rows: int,
                grad: bool, extra=()):
    """Device, type, shape and geometry checks; returns the library."""
    dev = x.device
    bb, K, N = basis.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x must be [rows, {K}]")
    if tuple(coeff.shape) != (n_rels, bb):
        raise ValueError(f"coeff must be [{n_rels}, {bb}]")
    E = lay["src_local"].shape[0]
    chunk = lay["chunk"]
    n_chunks = lay["chunk_dst_blk"].shape[0]
    if E == 0 or E != n_chunks * chunk or E >= 2 ** 31:
        raise ValueError(f"{E} edges do not fill {n_chunks} chunks of "
                         f"{chunk} (or exceed int32)")
    if n_rows == 0 or n_rows > lay["n_cap"]:
        raise ValueError(f"{n_rows} rows: the layout has {lay['n_cap']}")
    if grad and "edges" not in lay:
        raise ValueError("K6b reads the forward layout (layout_on with "
                         "prefix '')")
    for k in LAYOUT_KEYS + CSR_KEYS + (GRAD_KEYS if grad else ()):
        t = lay[k]
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"layout {k} must be contiguous on {dev}")
        want = n_chunks if k.startswith("chunk_") else E
        if k in LAYOUT_KEYS and t.shape != (want,):
            raise ValueError(f"layout {k} must have {want} entries")
    for t in (basis, coeff, *extra):
        if t.device != dev:
            raise ValueError(f"operand on {t.device}, x on {dev}")
    if -(-N // 32) > 65535:
        raise ValueError(f"K6a's grid: {N} output columns make more than "
                         "65,535 column tiles of 32")
    tiles = -(-K // GRAD_TILE) * -(-N // GRAD_TILE)
    if grad and (bb > 65535 or tiles > 65535):
        raise ValueError(f"K6b's grid: {bb} bases and {tiles} dbasis tiles "
                         "of 128 x 128 must each be at most 65,535")
    return _kernel()


def _padded_basis(basis: torch.Tensor, KP: int, NP: int) -> torch.Tensor:
    """``basis [Bb, K, N]`` as contiguous bf16 ``[Bb, KP, NP]``."""
    if basis.shape[1] != KP:
        basis = torch.nn.functional.pad(basis, (0, 0, 0, KP - basis.shape[1]))
    return _padded(basis, NP)


def _padded(t: torch.Tensor, cols: int) -> torch.Tensor:
    """``t`` as contiguous bf16 with its last dimension zero-padded to
    ``cols`` (the kernels' 16-byte row copies and 16-deep products)."""
    t = t.to(torch.bfloat16)
    if t.shape[-1] != cols:
        t = torch.nn.functional.pad(t, (0, cols - t.shape[-1]))
    return t.contiguous()


def _widths(K: int, N: int):
    """(K padded to the products' depth of 16, N to a 32-column tile)."""
    return -(-K // 16) * 16, -(-N // 32) * 32


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
    lib = _check_cuda(x, basis, coeff, lay, n_rels, n, False)
    bb, K, N = basis.shape
    KP, NP = _widths(K, N)
    xb = _padded(x, KP)
    vb = _padded_basis(basis, KP, NP)
    cf = coeff.to(torch.float32).contiguous()
    out = torch.empty((n, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mpqe_rgcn_blocked_forward(
            xb.data_ptr(), n, vb.data_ptr(), cf.data_ptr(), n_rels, bb, KP,
            NP, N, *(lay[k].data_ptr() for k in CSR_KEYS),
            lay["cta_rows"].shape[0] - 1, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6a kernel launch failed: cudaError {err}")
    messages_blocked.launches += 1
    return out


messages_blocked.launches = 0


def grad_blocked_parts(x: torch.Tensor, g: torch.Tensor,
                       basis: torch.Tensor, coeff: torch.Tensor,
                       lay: Dict[str, object], n_rels: int):
    """K6b with its per-edge terms: ``(dbasis [Bb, d, d_out], dcoeff [R,
    Bb], s [E, Bb])``, ``s`` the kernel's bf16 ``s_eb`` at each real
    edge's layout position (0 at padding edges).  CUDA tensors only;
    counted in ``grad_blocked.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"grad_blocked_parts: unsupported device "
                         f"{x.device}")
    n = x.shape[0]
    bb, K, N = basis.shape
    if tuple(g.shape) != (n, N):
        raise ValueError(f"g must be [{n}, {N}]")
    lib = _check_cuda(x, basis, coeff, lay, n_rels, n, True, (g,))
    E = lay["src_local"].shape[0]
    n_part = lay["part_ptr"].shape[0] - 1
    KP, NP = _widths(K, N)
    T = bb * K * N + n_rels * bb
    dev = x.device
    xb, gb = _padded(x, KP), _padded(g, NP)
    vb = _padded_basis(basis, KP, NP)
    cf = coeff.to(torch.float32).contiguous()
    s = torch.zeros((E, bb), dtype=torch.float32, device=dev)
    n_nt = -(-N // GRAD_TILE)
    s_part = (torch.empty((n_nt, E, bb), dtype=torch.float32, device=dev)
              if max(K, N) > GRAD_TILE else None)
    partial = torch.empty((n_part, T), dtype=torch.float32, device=dev)
    out = torch.empty((T,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mpqe_rgcn_blocked_grad(
            xb.data_ptr(), gb.data_ptr(), n, vb.data_ptr(), cf.data_ptr(),
            n_rels, bb, K, N, *(lay[k].data_ptr() for k in (
                "edges", "edge_pos", "part_ptr")), n_part,
            lay["dc_pos"].data_ptr(), lay["dc"].data_ptr(), E, s.data_ptr(),
            None if s_part is None else s_part.data_ptr(), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6b kernel launch failed: cudaError {err}")
    grad_blocked.launches += 1
    return (out[:bb * K * N].view(bb, K, N),
            out[bb * K * N:].view(n_rels, bb), s)


def grad_blocked(x: torch.Tensor, g: torch.Tensor, basis: torch.Tensor,
                 coeff: torch.Tensor, lay: Dict[str, object], n_rels: int):
    """K6b: ``(dbasis [Bb, d, d_out], dcoeff [R, Bb])`` f32 of K6a for the
    cotangent ``g [N, d_out]`` over the forward layout.  CUDA tensors: the
    kernel (:func:`grad_blocked_parts`), counted once in
    ``grad_blocked.launches``; CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return grad_blocked_reference(x, g, basis, coeff, lay, n_rels)
    return grad_blocked_parts(x, g, basis, coeff, lay, n_rels)[:2]


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


def rgcn_sparse_blocked(x: torch.Tensor, layer, bucketed,
                        n_rels: int) -> torch.Tensor:
    """Full R-GCN layer through the blocked bf16 kernels (basis layers).
    ``bucketed`` comes from :func:`bucket_edges_blocked` (numpy) or
    ``template_blocked`` (tensors), transpose arrays included, or is the
    pair :func:`layouts_on` built from one (once for all of an encode's
    layers).  Expect ~1e-2 relative deviation from the f32 paths (bf16
    products)."""
    if layer.basis is None:
        raise ValueError(
            "rgcn_sparse_blocked requires basis decomposition; use "
            "rgcn_sparse_fused for full-weight models")
    if isinstance(bucketed, tuple):
        lay, t_lay = bucketed
    elif "t_src_local" not in bucketed:
        raise ValueError(
            "bucketed dict lacks the transpose layout needed by the "
            "backward; re-run bucket_edges_blocked(with_transpose=True)")
    else:
        lay, t_lay = layouts_on(bucketed, x.device)
    agg = BlockedMessages.apply(x, layer.basis, layer.coeff, lay, t_lay,
                                n_rels)
    return x @ layer.w_self + agg + layer.bias
