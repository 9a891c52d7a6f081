"""Readouts: batched node embeddings -> one query vector (counterpart of
``mpqe_tpu/models/readout.py``): TGT (take the target slot), SUM, MAX,
CONCAT (pad-to-4-slots linear) and MLP (deep-sets).  Products promote as
JAX's do (``ops/dtypes.py:matmul``): ``encode_sparse`` of a bf16 model
reads out f32 activations through bf16 weights, in f32."""

from __future__ import annotations

import math

import torch
from torch import nn

from mpqe_tpu_torch.ops import dtypes
from mpqe_tpu_torch.ops.rgcn import normal_

READOUTS = ("tgt", "sum", "max", "concat", "mlp")
MAX_TEMPLATE_NODES = 4  # largest canonical structure (SURVEY.md §A.2)

# leaf name -> shape as a function of d, per readout kind
_LEAVES = {
    "tgt": {},
    "sum": {},
    "max": {},
    "concat": {"w_cat": lambda d: (MAX_TEMPLATE_NODES * d, d),
               "b_cat": lambda d: (d,)},
    "mlp": {"w_pre": lambda d: (d, d), "b_pre": lambda d: (d,),
            "w_post": lambda d: (d, d), "b_post": lambda d: (d,)},
}


class Readout(nn.Module):
    """Readout parameters under the reference's leaf names."""

    def __init__(self, kind: str, d: int, device=None):
        super().__init__()
        if kind not in READOUTS:
            raise ValueError(f"unknown readout {kind!r}; options: {READOUTS}")
        self.kind = kind
        for leaf, shape in _LEAVES[kind].items():
            self.register_parameter(
                leaf, nn.Parameter(torch.empty(shape(d), device=device)))


def init_readout(gen: torch.Generator, kind: str, d: int,
                 device=None) -> Readout:
    ro = Readout(kind, d, device=device)
    scale = math.sqrt(2.0 / (2 * d))
    with torch.no_grad():
        if kind == "concat":
            n = MAX_TEMPLATE_NODES * d
            ro.w_cat.copy_(normal_(gen, (n, d), math.sqrt(2.0 / (n + d)),
                                   device))
            ro.b_cat.zero_()
        elif kind == "mlp":
            ro.w_pre.copy_(normal_(gen, (d, d), scale, device))
            ro.b_pre.zero_()
            ro.w_post.copy_(normal_(gen, (d, d), scale, device))
            ro.b_post.zero_()
    return ro


def readout_dense(kind: str, ro: Readout, x: torch.Tensor,
                  target_slot: int) -> torch.Tensor:
    """``x [B, n_nodes, d]`` -> ``[B, d]``."""
    B, n, d = x.shape
    if kind == "tgt":
        return x[:, target_slot, :]
    if kind == "sum":
        return torch.sum(x, dim=1)
    if kind == "max":
        return torch.amax(x, dim=1)
    if kind == "concat":
        pad = x.new_zeros((B, MAX_TEMPLATE_NODES - n, d))
        flat = torch.cat([x, pad], dim=1).reshape(B, MAX_TEMPLATE_NODES * d)
        return dtypes.matmul(flat, ro.w_cat) + ro.b_cat
    if kind == "mlp":
        h = torch.relu(dtypes.matmul(x, ro.w_pre) + ro.b_pre)
        pooled = torch.sum(h, dim=1)
        return dtypes.matmul(pooled, ro.w_post) + ro.b_post
    raise ValueError(kind)


def readout_sparse(kind: str, ro: Readout, x: torch.Tensor,
                   node_query: torch.Tensor, target_node: torch.Tensor,
                   n_queries: int, n_template_nodes=None,
                   segment_backend: str = "xla", layout=None) -> torch.Tensor:
    """Flat ``x [N, d]`` with a ``node_query [N]`` segment map ->
    ``[n_queries, d]``.  ``concat`` needs a slot-regular batch
    (``n_template_nodes`` nodes per query, in query order).  ``layout``:
    with ``segment_backend="pallas"``, ``segment_layout(node_query,
    n_queries)`` for the sum, max and mlp readouts (built by the
    reduction when ``None``)."""
    from mpqe_tpu_torch.ops import segment as segment_ops

    if kind == "tgt":
        return x[target_node.long().clamp(0, x.shape[0] - 1)]
    if kind == "sum":
        return segment_ops.segment_sum(x, node_query, n_queries,
                                       backend=segment_backend, layout=layout)
    if kind == "max":
        return segment_ops.segment_max(x, node_query, n_queries,
                                       backend=segment_backend, layout=layout)
    if kind == "concat":
        n = n_template_nodes
        if n is None:
            raise ValueError("concat readout needs n_template_nodes")
        return readout_dense(kind, ro, x.reshape(n_queries, n, x.shape[-1]),
                             0)
    if kind == "mlp":
        h = torch.relu(dtypes.matmul(x, ro.w_pre) + ro.b_pre)
        pooled = segment_ops.segment_sum(h, node_query, n_queries,
                                         backend=segment_backend,
                                         layout=layout)
        return dtypes.matmul(pooled, ro.w_post) + ro.b_post
    raise ValueError(kind)
