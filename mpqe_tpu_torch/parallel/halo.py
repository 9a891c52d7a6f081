"""Edge-partitioned R-GCN layers (counterpart of
``mpqe_tpu/parallel/halo.py``): the graph analog of sequence parallelism.

The batched query graph's nodes split into P contiguous blocks, one per
part of a mesh axis; each edge lives with the part that owns its
destination, and the remote source features (the halo) arrive by
collectives (``parallel/mesh.py``):

  * :func:`rgcn_dst_partitioned` (axis ``data``) — the halo by
    ``all_gather``; the aggregation is local.
  * :func:`rgcn_rel_partitioned` (axis ``model``) — each part owns a
    relation block, partial sums ``psum`` over the axis.
  * :func:`rgcn_2d_partitioned` — both at once on a (data, model) mesh.
  * :func:`rgcn_ring_halo` (axis ``data``) — the node block circulates in
    P - 1 ``ppermute`` hops, each hop aggregating the edges whose source
    block it carries (``ops/ring.py`` is its hand-scheduled kernel, K8).

The layers keep the reference's public layout: they take the global
padded ``x [P * block, d]`` and the ``[P, e_max]`` / ``[P, P, e_max]``
edge arrays, and return the global ``[P * block, d_out]`` on ``x``'s
device.  Inside, part p's block and edges go to the mesh's device p, the
per-part function runs there (parameters are copied there, the
replicated in_spec), and the parts' outputs are concatenated.  Every
operation is differentiable; destination sums are ``ops/segment.py``'s
``"xla"`` ``segment_sum``, as in the reference.  Edge normalizers come
from the full graph before partitioning, so distribution never changes
the math.  The partitioners are numpy copies of the reference's.

On a mesh that spans processes (``multihost.global_mesh``) each process
iterates over its own parts only, with the replicated ``x`` in and the
whole output out in every process; the collectives exchange the rest
(``parallel/mesh.py``).  :func:`rgcn_ring_halo` and
:func:`rgcn_dst_partitioned` train so (their parameters enter the parts
through ``enter_parts``, whose backward sums the processes' gradients);
:func:`rgcn_rel_partitioned` and :func:`rgcn_2d_partitioned` run forward
only across processes (the reference's tests hold them forward) and
raise ``NotImplementedError`` in grad mode there.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from mpqe_tpu_torch.ops import dtypes
from mpqe_tpu_torch.ops import segment as segment_ops
from mpqe_tpu_torch.ops.edge_store import EdgeStore
from mpqe_tpu_torch.ops.rgcn import RGCNLayer
from mpqe_tpu_torch.parallel import mesh as mesh_lib
from mpqe_tpu_torch.parallel.mesh import Mesh


# ----------------------------------------------------------------------
# Host-side partitioners
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DstPartitionedEdges:
    """Edges grouped by destination-node block, padded per part.

    Arrays are ``[n_parts, e_max]``; ``dst_local`` is relative to the
    part's node-block start; padding rows have ``rel == n_rels``,
    ``dst_local == block_size`` (dropped by segment bounds) and zero norm.
    """

    src: np.ndarray
    dst_local: np.ndarray
    rel: np.ndarray
    norm: np.ndarray
    n_parts: int
    block_size: int  # nodes per part (n_nodes padded to n_parts*block)
    n_nodes: int  # true node count
    n_rels: int

    @property
    def n_nodes_padded(self) -> int:
        return self.n_parts * self.block_size


def partition_edges_by_dst(
    store: EdgeStore, n_parts: int, pad_multiple: int = 8
) -> DstPartitionedEdges:
    block = -(-store.n_nodes // n_parts)
    m = store.pad_mask
    src, dst, rel, norm = store.src[m], store.dst[m], store.rel[m], store.norm[m]
    part = dst // block
    e_max = max(int(np.bincount(part, minlength=n_parts).max()), 1)
    e_max = ((e_max + pad_multiple - 1) // pad_multiple) * pad_multiple

    o_src = np.zeros((n_parts, e_max), dtype=np.int32)
    o_dst = np.full((n_parts, e_max), block, dtype=np.int32)
    o_rel = np.full((n_parts, e_max), store.n_rels, dtype=np.int32)
    o_norm = np.zeros((n_parts, e_max), dtype=np.float32)
    for p in range(n_parts):
        sel = part == p
        k = int(sel.sum())
        o_src[p, :k] = src[sel]
        o_dst[p, :k] = dst[sel] - p * block
        o_rel[p, :k] = rel[sel]
        o_norm[p, :k] = norm[sel]
    return DstPartitionedEdges(
        src=o_src, dst_local=o_dst, rel=o_rel, norm=o_norm,
        n_parts=n_parts, block_size=block, n_nodes=store.n_nodes,
        n_rels=store.n_rels,
    )


def pad_node_features(x: np.ndarray, pe: DstPartitionedEdges) -> np.ndarray:
    padded = np.zeros((pe.n_nodes_padded, x.shape[1]), dtype=x.dtype)
    padded[: x.shape[0]] = x
    return padded


@dataclasses.dataclass(frozen=True)
class RingPartitionedEdges:
    """Edges grouped by (destination block, SOURCE block), padded.

    Arrays are ``[n_parts, n_parts, e_max]`` (dst block, src block, edge):
    ``src_local``/``dst_local`` are block-relative.  During the ring pass,
    when the buffer holding source block ``b`` arrives at destination
    block ``p``, exactly the ``[p, b]`` edge set is aggregated.
    """

    src_local: np.ndarray
    dst_local: np.ndarray
    rel: np.ndarray
    norm: np.ndarray
    n_parts: int
    block_size: int
    n_nodes: int
    n_rels: int

    @property
    def n_nodes_padded(self) -> int:
        return self.n_parts * self.block_size


def partition_edges_ring(
    store: EdgeStore, n_parts: int, pad_multiple: int = 8
) -> RingPartitionedEdges:
    block = -(-store.n_nodes // n_parts)
    m = store.pad_mask
    src, dst = store.src[m], store.dst[m]
    rel, norm = store.rel[m], store.norm[m]
    dp = (dst // block).astype(np.int64)
    sp = (src // block).astype(np.int64)
    key = dp * n_parts + sp
    counts = np.bincount(key, minlength=n_parts * n_parts)
    e_max = max(int(counts.max()), 1)
    e_max = ((e_max + pad_multiple - 1) // pad_multiple) * pad_multiple

    order = np.argsort(key, kind="stable")
    key_s = key[order]
    starts = np.zeros(n_parts * n_parts, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(key_s.size, dtype=np.int64) - starts[key_s]
    flat = key_s * e_max + pos

    o_src = np.zeros((n_parts * n_parts * e_max,), np.int32)
    o_dst = np.full((n_parts * n_parts * e_max,), block, np.int32)  # dropped
    o_rel = np.full((n_parts * n_parts * e_max,), store.n_rels, np.int32)
    o_norm = np.zeros((n_parts * n_parts * e_max,), np.float32)
    o_src[flat] = (src - sp * block)[order]
    o_dst[flat] = (dst - dp * block)[order]
    o_rel[flat] = rel[order]
    o_norm[flat] = norm[order]
    shape = (n_parts, n_parts, e_max)
    return RingPartitionedEdges(
        src_local=o_src.reshape(shape), dst_local=o_dst.reshape(shape),
        rel=o_rel.reshape(shape), norm=o_norm.reshape(shape),
        n_parts=n_parts, block_size=block, n_nodes=store.n_nodes,
        n_rels=store.n_rels,
    )


# ----------------------------------------------------------------------
# The layers
# ----------------------------------------------------------------------
def _basis_and_coeff(layer: RGCNLayer, rel_cl: torch.Tensor, n_b_rels: int,
                     device, coeff_rows=None):
    """(basis, per-edge coefficients) on ``device``: the layer's bases and
    ``coeff_rows[rel_cl]``, or for a full-weight layer ``w_rel`` (or its
    rows ``coeff_rows``) as ``n_b_rels`` one-hot "bases"."""
    if layer.w_rel is not None:
        basis = (layer.w_rel if coeff_rows is None else coeff_rows).to(device)
        coeff_e = torch.nn.functional.one_hot(rel_cl, n_b_rels).to(
            basis.dtype)
    else:
        basis = layer.basis.to(device)
        rows = layer.coeff if coeff_rows is None else coeff_rows
        coeff_e = rows.to(device)[rel_cl]
    return basis, coeff_e


def _messages(x_src: torch.Tensor, basis: torch.Tensor, coeff_e, src_e,
              norm_e) -> torch.Tensor:
    """``(sum_b coeff_e[e, b] (x_src @ V_b)[src_e]) * norm_e``, basis
    first, as the reference's local functions compute it: f32 products
    (its ``preferred_element_type``), an f32 result at any leaf dtype."""
    h_b = dtypes.einsum_f32("nd,bdo->nbo", x_src, basis)
    msg = dtypes.einsum_f32("eb,ebo->eo", coeff_e, h_b[src_e])
    return msg * norm_e[:, None].to(msg.dtype)


def _local(devs) -> list:
    """The parts this process computes: its own on a mesh that spans
    processes, else all."""
    return list(getattr(devs, "local", range(len(devs))))


def _entered(layer: RGCNLayer, devs, what: str):
    """``layer`` as its parts read it: itself in one process; across
    processes its parameters through ``mesh_lib.enter_parts`` (a
    namespace of the same names).  ``ValueError`` when this process holds
    no part of the axis (its loss would not reach the backward's
    exchanges)."""
    if mesh_lib._mode(devs) == "local":
        return layer
    if not devs.local:
        raise ValueError(f"{what}: this process holds no part of the axis")
    names = ("w_self", "bias", "basis", "coeff", "w_rel")
    held = [n for n in names if getattr(layer, n) is not None]
    vals = dict(zip(held, mesh_lib.enter_parts(
        [getattr(layer, n) for n in held], devs)))
    return types.SimpleNamespace(**{n: vals.get(n) for n in names})


def _forward_only(what: str, mesh: Mesh, x: torch.Tensor,
                  layer: RGCNLayer) -> None:
    if (mesh.spans_processes and torch.is_grad_enabled()
            and (x.requires_grad
                 or any(p.requires_grad for p in layer.parameters()))):
        raise NotImplementedError(
            f"{what} runs forward only across processes (torch.no_grad)")


def _self_term(layer: RGCNLayer, x_local: torch.Tensor, agg: torch.Tensor):
    dev = x_local.device
    return (dtypes.dot_f32(x_local, layer.w_self.to(dev)) + agg
            + layer.bias.to(dev))


def rgcn_dst_partitioned(
    mesh: Mesh,
    layer: RGCNLayer,
    x_padded: torch.Tensor,  # [n_nodes_padded, d]
    pe_src: torch.Tensor,  # [n_parts, e_max]
    pe_dst_local: torch.Tensor,
    pe_rel: torch.Tensor,
    pe_norm: torch.Tensor,
    n_rels: int,
    axis: str = "data",
) -> torch.Tensor:
    """One distributed R-GCN layer (halo by ``all_gather``); returns
    ``[n_nodes_padded, d_out]`` on ``x_padded``'s device."""
    devs = mesh.axis_devices(axis)
    layer = _entered(layer, devs, "rgcn_dst_partitioned")
    xs = mesh_lib.scatter_blocks(x_padded, devs)
    x_full = mesh_lib.all_gather(xs, devs)
    outs = [None] * len(devs)
    for p in _local(devs):
        dev = devs[p]
        n_all = x_full[p].shape[0]
        src_e = pe_src[p].to(dev).long().clamp(0, n_all - 1)
        rel_cl = pe_rel[p].to(dev).long().clamp(0, n_rels - 1)
        n_b = layer.w_rel.shape[0] if layer.w_rel is not None else 0
        basis, coeff_e = _basis_and_coeff(layer, rel_cl, n_b, dev)
        msg = _messages(x_full[p], basis, coeff_e, src_e,
                        pe_norm[p].to(dev))
        agg = segment_ops.segment_sum(msg, pe_dst_local[p].to(dev),
                                      xs[p].shape[0])
        outs[p] = _self_term(layer, xs[p], agg)
    return mesh_lib.gather_blocks(outs, x_padded.device, devs)


def _relation_block(n_rels: int, n_parts: int) -> int:
    if n_rels % n_parts != 0:
        raise ValueError(
            f"n_rels {n_rels} must be divisible by model-axis size {n_parts} "
            "(pad the relation vocab)")
    return n_rels // n_parts


def _rel_block_messages(layer: RGCNLayer, x_src, j: int, r_block: int,
                        src_e, rel, norm, dev):
    """Part j's messages: only the edges of relations
    ``[j * r_block, (j + 1) * r_block)``, its slice of ``coeff`` or
    ``w_rel`` (sharded on axis 0 in the reference)."""
    rel_local = rel.long() - j * r_block
    mine = (rel_local >= 0) & (rel_local < r_block)
    rel_cl = rel_local.clamp(0, r_block - 1)
    w = layer.w_rel if layer.w_rel is not None else layer.coeff
    basis, coeff_e = _basis_and_coeff(
        layer, rel_cl, r_block, dev,
        coeff_rows=w[j * r_block:(j + 1) * r_block])
    coeff_e = coeff_e * mine[:, None].to(coeff_e.dtype)
    return _messages(x_src, basis, coeff_e, src_e, norm)


def rgcn_rel_partitioned(
    mesh: Mesh,
    layer: RGCNLayer,
    x: torch.Tensor,  # [N, d]
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_rel: torch.Tensor,
    edge_norm: torch.Tensor,
    n_rels: int,
    axis: str = "model",
) -> torch.Tensor:
    """Each part owns a relation block: messages for the edges of its
    relations, partial segment sums, then ``psum`` over the axis.  The
    parts run on the axis's devices at the first position of the other
    axis (in the reference the other axis holds replicas)."""
    _forward_only("rgcn_rel_partitioned", mesh, x, layer)
    devs = mesh.axis_devices(axis)
    r_block = _relation_block(n_rels, len(devs))
    n_nodes = x.shape[0]
    aggs = [None] * len(devs)
    for j in _local(devs):
        dev = devs[j]
        xj = x.to(dev)
        src_e = edge_src.to(dev).long().clamp(0, n_nodes - 1)
        msg = _rel_block_messages(layer, xj, j, r_block, src_e,
                                  edge_rel.to(dev), edge_norm.to(dev), dev)
        aggs[j] = segment_ops.segment_sum(msg, edge_dst.to(dev), n_nodes)
    summed = mesh_lib.psum(aggs, devs)
    agg = summed[_local(devs)[0]].to(x.device)
    return _self_term(layer, x, agg)


def rgcn_2d_partitioned(
    mesh: Mesh,
    layer: RGCNLayer,
    x_padded: torch.Tensor,  # [n_nodes_padded, d]
    pe_src: torch.Tensor,  # [n_data_parts, e_max]
    pe_dst_local: torch.Tensor,
    pe_rel: torch.Tensor,
    pe_norm: torch.Tensor,
    n_rels: int,
    data_axis: str = "data",
    model_axis: str = "model",
) -> torch.Tensor:
    """One R-GCN layer on a (data, model) mesh: part (i, j) owns the
    (destination block i, relation block j) tile of the edge set.  The
    halo all-gathers over the data axis, the partial sums ``psum`` over
    the model axis; the result of model position 0 is returned."""
    _forward_only("rgcn_2d_partitioned", mesh, x_padded, layer)
    n_data, n_model = mesh.shape[data_axis], mesh.shape[model_axis]
    r_block = _relation_block(n_rels, n_model)
    cols = [mesh.axis_devices(data_axis, j) for j in range(n_model)]
    xs = [mesh_lib.scatter_blocks(x_padded, c) for c in cols]  # [j][i]
    x_full = [mesh_lib.all_gather(xs[j], cols[j]) for j in range(n_model)]
    outs = [None] * n_data
    for i in range(n_data):
        devs = mesh.axis_devices(model_axis, i)
        mine = _local(devs)
        if not mine and mesh_lib._mode(devs) != "spans":
            continue  # another process's row
        aggs = [None] * n_model
        for j in mine:
            dev = cols[j][i]
            n_all = x_full[j][i].shape[0]
            src_e = pe_src[i].to(dev).long().clamp(0, n_all - 1)
            msg = _rel_block_messages(layer, x_full[j][i], j, r_block, src_e,
                                      pe_rel[i].to(dev), pe_norm[i].to(dev),
                                      dev)
            aggs[j] = segment_ops.segment_sum(
                msg, pe_dst_local[i].to(dev), xs[j][i].shape[0])
        agg = mesh_lib.psum(aggs, devs)[0]
        if agg is not None:
            outs[i] = _self_term(layer, xs[0][i], agg)
    return mesh_lib.gather_blocks(outs, x_padded.device, cols[0])


def rgcn_ring_halo(
    mesh: Mesh,
    layer: RGCNLayer,
    x_padded: torch.Tensor,  # [n_nodes_padded, d]
    pe_src_local: torch.Tensor,  # [P, P, e_max]
    pe_dst_local: torch.Tensor,
    pe_rel: torch.Tensor,
    pe_norm: torch.Tensor,
    n_rels: int,
    axis: str = "data",
) -> torch.Tensor:
    """One distributed R-GCN layer with a ring-circulated halo: each part's
    node block travels the ring in P - 1 ``ppermute`` hops, and at hop s
    part p aggregates the ``[p, (p - s) % P]`` edges from the block it
    holds, into an accumulator added hop by hop."""
    devs = mesh.axis_devices(axis)
    n_parts = len(devs)
    layer = _entered(layer, devs, "rgcn_ring_halo")
    xs = mesh_lib.scatter_blocks(x_padded, devs)
    block = x_padded.shape[0] // n_parts
    d_out = layer.w_self.shape[1]

    def process(p, acc, buf, src_block):
        dev = devs[p]
        r = pe_rel[p, src_block].to(dev).long()
        rel_cl = r.clamp(0, n_rels - 1)
        n_b = layer.w_rel.shape[0] if layer.w_rel is not None else 0
        basis, coeff_e = _basis_and_coeff(layer, rel_cl, n_b, dev)
        coeff_e = coeff_e * (r < n_rels)[:, None].to(coeff_e.dtype)
        sl = pe_src_local[p, src_block].to(dev).long().clamp(0, block - 1)
        msg = _messages(buf, basis, coeff_e, sl,
                        pe_norm[p, src_block].to(dev))
        return acc + segment_ops.segment_sum(
            msg, pe_dst_local[p, src_block].to(dev), block)

    mine = _local(devs)
    accs = [None] * n_parts
    for p in mine:
        accs[p] = torch.zeros((block, d_out), dtype=torch.float32,
                              device=devs[p])
    bufs = xs
    for s in range(n_parts):
        if s:
            bufs = mesh_lib.ppermute(bufs, devs)
        for p in mine:
            accs[p] = process(p, accs[p], bufs[p], (p - s) % n_parts)
    outs = [None] * n_parts
    for p in mine:
        outs[p] = _self_term(layer, xs[p], accs[p])
    return mesh_lib.gather_blocks(outs, x_padded.device, devs)
