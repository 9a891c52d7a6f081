"""Basis-decomposed R-GCN layer parameters (counterpart of
``mpqe_tpu/ops/rgcn.py``).

    h_i' = W_0 h_i + sum_r sum_{j in N_r(i)} (1 / c_{i,r}) W_r h_j + b
    W_r  = sum_b a_{r,b} V_b                      (basis decomposition)

A layer is an ``nn.Module`` whose parameter names are the reference's
leaf names: ``w_self``, ``bias`` and either ``basis``/``coeff`` or
``w_rel``.  Two layer forms: ``rgcn_dense_template`` (B copies of a
static query template) and the general sparse ``rgcn_sparse`` /
``rgcn_sparse_relblock`` (the f32 oracles of the sparse kernels in
``ops/rgcn_fused.py`` and ``ops/rgcn_blocked.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mpqe_tpu_torch.ops import dtypes


def normal_(gen: torch.Generator, shape, scale: float,
            device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn from ``gen`` on its own device, then
    placed on ``device`` (no copy when they match)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(device)


class RGCNLayer(nn.Module):
    """One R-GCN layer's parameters (uninitialized until filled)."""

    def __init__(self, d_in: int, d_out: int, n_rels: int,
                 num_bases: Optional[int] = None, device=None):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.w_self = p(d_in, d_out)
        self.bias = p(d_out)
        if num_bases is None:
            self.w_rel = p(n_rels, d_in, d_out)
            self.basis = self.coeff = None
        else:
            self.basis = p(num_bases, d_in, d_out)
            self.coeff = p(n_rels, num_bases)
            self.w_rel = None


def init_rgcn_layer(
    gen: torch.Generator,
    d_in: int,
    d_out: int,
    n_rels: int,
    num_bases: Optional[int] = None,
    device=None,
) -> RGCNLayer:
    """Glorot-initialized R-GCN layer: with ``num_bases=None`` full
    per-relation weights ``w_rel [R, d_in, d_out]``, otherwise basis
    matrices ``basis [B, d_in, d_out]`` plus coefficients ``coeff [R, B]``.
    Same distributions as the reference; the bits differ (torch RNG)."""
    layer = RGCNLayer(d_in, d_out, n_rels, num_bases, device=device)
    scale = math.sqrt(2.0 / (d_in + d_out))
    with torch.no_grad():
        layer.w_self.copy_(normal_(gen, (d_in, d_out), scale, device))
        layer.bias.zero_()
        if num_bases is None:
            layer.w_rel.copy_(
                normal_(gen, (n_rels, d_in, d_out), scale, device))
        else:
            layer.basis.copy_(
                normal_(gen, (num_bases, d_in, d_out), scale, device))
            layer.coeff.copy_(normal_(gen, (n_rels, num_bases),
                                      1.0 / math.sqrt(num_bases), device))
    return layer


def relation_weights(layer: RGCNLayer) -> torch.Tensor:
    """Materialize ``W_r`` for all relations: ``[R, d_in, d_out]`` in the
    leaves' dtype (at bf16 summed in f32 and rounded once, as XLA's bf16
    einsum of the reference rounds it)."""
    if layer.w_rel is not None:
        return layer.w_rel
    return dtypes.einsum_f32("rb,bio->rio", layer.coeff, layer.basis).to(
        layer.basis.dtype)


def _edge_weights(layer: RGCNLayer, edge_rel: torch.Tensor) -> torch.Tensor:
    """``W_{rel_e}`` for a (small) set of edges: ``[E, d_in, d_out]`` in
    the leaves' dtype.  At bf16 the basis combination is summed in f32
    and rounded once, as XLA's bf16 einsum of the reference rounds it."""
    if layer.w_rel is not None:
        return layer.w_rel[edge_rel.long()]
    coeff = layer.coeff[edge_rel.long()]  # [E, B]
    return dtypes.einsum_f32("eb,bio->eio", coeff, layer.basis).to(
        layer.basis.dtype)


def rgcn_sparse(x: torch.Tensor, layer: RGCNLayer, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, edge_rel: torch.Tensor,
                edge_norm: torch.Tensor, n_rels: int,
                segment_backend: str = "xla", layout=None) -> torch.Tensor:
    """One R-GCN layer over an arbitrary padded edge list (reference
    ``rgcn_sparse``, the f32 oracle of the sparse kernels).  Basis-first:
    ``H[n, b] = x[n] @ V_b``, ``msg_e = sum_b a[rel_e, b] H[src_e, b]``,
    scaled by ``norm_e`` and summed into ``dst_e``.  ``src`` and ``rel``
    are clamped; padding edges carry ``dst == N`` (dropped by the segment
    sum) and ``norm == 0``.  A full-weight layer is treated as R one-hot
    "bases".  ``layout``: with ``segment_backend="pallas"``, the
    destination sum's ``segment_layout(edge_dst, N)``, built once for all
    layers by the caller (else by the sum)."""
    from mpqe_tpu_torch.ops import segment as segment_ops

    n_nodes = x.shape[0]
    src_c = edge_src.long().clamp(0, n_nodes - 1)
    rel_cl = edge_rel.long().clamp(0, n_rels - 1)
    if layer.w_rel is not None:
        basis = layer.w_rel
        coeff_e = torch.nn.functional.one_hot(
            rel_cl, basis.shape[0]).to(x.dtype)  # [E, R]
    else:
        basis = layer.basis
        coeff_e = layer.coeff[rel_cl]  # [E, B]
    h_b = dtypes.einsum_f32("nd,bdo->nbo", x, basis)
    msg = dtypes.einsum_f32("eb,ebo->eo", coeff_e, h_b[src_c])
    msg = msg * edge_norm[:, None].to(msg.dtype)
    agg = segment_ops.segment_sum(msg, edge_dst, n_nodes,
                                  backend=segment_backend, layout=layout)
    return dtypes.dot_f32(x, layer.w_self) + agg + layer.bias


def rgcn_sparse_relblock(x: torch.Tensor, layer: RGCNLayer,
                         edge_src: torch.Tensor, edge_dst: torch.Tensor,
                         edge_rel: torch.Tensor, edge_norm: torch.Tensor,
                         n_rels: int) -> torch.Tensor:
    """Relation-gathered variant: ``W_{rel_e}`` materialized per edge
    (``[E, d, d]``; small E only), a second oracle for kernel tests."""
    from mpqe_tpu_torch.ops import segment as segment_ops

    n_nodes = x.shape[0]
    w = relation_weights(layer)
    w_e = w[edge_rel.long().clamp(0, n_rels - 1)]
    xs = x[edge_src.long().clamp(0, n_nodes - 1)]
    msg = dtypes.einsum_f32("ed,edo->eo", xs, w_e)
    msg = msg * edge_norm[:, None].to(msg.dtype)
    agg = segment_ops.segment_sum(msg, edge_dst, n_nodes)
    return dtypes.dot_f32(x, layer.w_self) + agg + layer.bias


def rgcn_dense_template(x: torch.Tensor, layer: RGCNLayer, edge_src,
                        edge_dst, edge_rel: torch.Tensor,
                        edge_norm: torch.Tensor) -> torch.Tensor:
    """One R-GCN layer over B copies of a static query-DAG template:
    ``x [B, n_nodes, d_in]`` → ``[B, n_nodes, d_out]`` f32 (f32 products
    of the leaves' dtype, as the reference's ``preferred_element_type``;
    the caller rounds).  ``edge_src`` / ``edge_dst`` are Python ints (the
    template), ``edge_rel`` / ``edge_norm`` the formula's ``[n_edges]``
    relations and 1/c."""
    w_e = _edge_weights(layer, edge_rel)  # [n_edges, d_in, d_out]
    out = dtypes.einsum_f32("bnd,do->bno", x, layer.w_self)
    cols = list(out.unbind(dim=1))
    for j in range(len(edge_src)):
        msg = dtypes.dot_f32(x[:, edge_src[j], :], w_e[j])
        cols[edge_dst[j]] = cols[edge_dst[j]] + msg * edge_norm[j].to(
            msg.dtype)
    return torch.stack(cols, dim=1) + layer.bias
