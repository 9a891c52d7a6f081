"""The MPQE model in PyTorch: R-GCN over batched query DAGs + readout +
cosine scoring (counterpart of ``mpqe_tpu/models/mpqe.py``).

``MPQE`` is an ``nn.Module`` whose parameter names are the reference's
pytree leaves (``emb.ent``, ``emb.var``, ``layers.{i}.w_self|bias|basis|
coeff|w_rel``, ``readout.*``), so a JAX checkpoint maps onto it one to
one (``convert.py``).  The forward functions are plain functions with the
reference's signatures: the per-query-relation encoder that serving and
evaluation run, the shared-relation dense encoder and its fused-kernel
form (K1 forward, K2 or a recomputation backward) that training runs, and
the margin losses (with per-query negatives, with batch-shared
negatives behind ``--shared_negatives``, and with one table lookup and a
chosen gradient scatter), and the sparse encoders (``encode_sparse``,
and its K5 and K6 forms behind ``--kernel fused`` and ``--kernel
blocked``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from mpqe_tpu_torch.models import embeddings as emb_mod
from mpqe_tpu_torch.models import readout as readout_mod
from mpqe_tpu_torch.ops import dtypes
from mpqe_tpu_torch.ops import embed as embed_ops
from mpqe_tpu_torch.ops import fused_fwd as fused_fwd_ops
from mpqe_tpu_torch.ops import rgcn as rgcn_ops
from mpqe_tpu_torch.ops import segment_kernels
from mpqe_tpu_torch.queries import STRUCTURES


@dataclasses.dataclass(frozen=True)
class MPQEConfig:
    n_entities: int
    n_modes: int
    n_rels: int  # directed relation vocab (forward + inverse)
    embed_dim: int = 128
    n_layers: int = 3
    num_bases: Optional[int] = None
    readout: str = "tgt"
    margin: float = 1.0
    scale_scores: bool = True  # cosine (normalized) vs raw dot scores
    dtype: Any = torch.float32  # the leaves' dtype: float32 or bfloat16

    def __post_init__(self):
        if self.readout not in readout_mod.READOUTS:
            raise ValueError(f"bad readout {self.readout}")
        dtypes.check_model_dtype(self.dtype)


class MPQE(nn.Module):
    """MPQE parameters in ``cfg.dtype`` (uninitialized; see
    :func:`init_mpqe`)."""

    def __init__(self, cfg: MPQEConfig, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.emb = emb_mod.Embeddings(cfg.n_entities, cfg.n_modes, d,
                                      device=device)
        self.layers = nn.ModuleList(
            rgcn_ops.RGCNLayer(d, d, cfg.n_rels, cfg.num_bases, device=device)
            for _ in range(cfg.n_layers))
        self.readout = readout_mod.Readout(cfg.readout, d, device=device)
        self.to(cfg.dtype)


def init_mpqe(gen: torch.Generator, cfg: MPQEConfig, device=None) -> MPQE:
    """A randomly initialized model on ``device``, drawn from ``gen`` (on
    the generator's own device).  Same distributions as the reference's
    ``init_mpqe``; torch's generator gives other bits than JAX's, so
    parity tests carry JAX parameters across instead.  Every leaf is
    drawn in f32 and rounded once to ``cfg.dtype``."""
    model = MPQE(cfg, device="meta")
    d = cfg.embed_dim
    model.emb = emb_mod.init_embeddings(gen, cfg.n_entities, cfg.n_modes, d,
                                        device=device)
    model.layers = nn.ModuleList(
        rgcn_ops.init_rgcn_layer(gen, d, d, cfg.n_rels, cfg.num_bases,
                                 device=device)
        for _ in range(cfg.n_layers))
    model.readout = readout_mod.init_readout(gen, cfg.readout, d,
                                             device=device)
    return model.to(cfg.dtype)


def num_steps(cfg: MPQEConfig, structure: str) -> int:
    """Message-passing depth for a bucket: TGT runs ``diameter`` steps
    (reference "TM" readout; SURVEY.md §3.2), others run all layers."""
    if cfg.readout == "tgt":
        return min(STRUCTURES[structure].diameter, cfg.n_layers)
    return cfg.n_layers


def executed_edge_messages(cfg: MPQEConfig, structure: str) -> int:
    """Edge messages the forward actually computes per query: the TGT
    readout's dead-slot-pruned plan skips messages into slots that can no
    longer reach the target (4 of the logical 6 for ``3-chain_inter``),
    so a throughput claim counts what runs, not ``steps * n_edges``."""
    spec = STRUCTURES[structure]
    steps = num_steps(cfg, structure)
    if cfg.readout == "tgt":
        return sum(len(edges) for _, _, edges in _live_slot_plan(spec, steps))
    return steps * spec.n_edges


def _live_slot_plan(spec, steps: int):
    """Per-layer (in_slots, out_slots, edge_ids) keeping only slots that
    can still influence the target within the remaining steps."""
    needed = {spec.target_slot}
    plan = []
    for _ in range(steps):
        out_slots = tuple(sorted(needed))
        edges = tuple(
            j for j in range(spec.n_edges) if spec.edge_dst[j] in needed
        )
        in_needed = set(needed)
        for j in edges:
            in_needed.add(spec.edge_src[j])
        plan.append((tuple(sorted(in_needed)), out_slots, edges))
        needed = in_needed
    plan.reverse()
    return plan


def anchor_gather_slots(cfg: MPQEConfig, structure: str):
    """Anchor slots whose entity rows the forward actually reads (the
    TGT-pruned path drops anchors that cannot reach the target within the
    available steps)."""
    spec = STRUCTURES[structure]
    anchors = set(spec.anchor_slots)
    if cfg.readout == "tgt":
        steps = num_steps(cfg, structure)
        in_slots0 = _live_slot_plan(spec, steps)[0][0]
        return tuple(s for s in in_slots0 if s in anchors)
    return tuple(s for s in range(spec.n_nodes) if s in anchors)


_entity_rows = emb_mod.entity_rows


def _encode_dense_tgt_pruned(model, cfg, spec, node_entity, node_mode,
                             edge_rel, edge_norm, steps, anchor_rows=None):
    """TGT forward over the live slots only (``_live_slot_plan``).
    Layer-0 variable slots stay factored: their transforms run on the
    ``[n_modes, d]`` table and are then selected per query (exactly the
    reference's one-hot matmul).  The reference's rounding points: f32
    products of ``cfg.dtype`` operands, ``(acc + bias)`` rounded to
    ``cfg.dtype`` once a layer."""
    plan = _live_slot_plan(spec, steps)
    in_slots0 = plan[0][0]
    anchors = set(spec.anchor_slots)
    a_col = {s: k for k, s in enumerate(s for s in in_slots0 if s in anchors)}
    xs = {}
    for s in in_slots0:
        if s in anchors:
            xs[s] = (anchor_rows[:, a_col[s], :] if anchor_rows is not None
                     else _entity_rows(model.emb.ent, node_entity[:, s]))
    var = model.emb.var
    for li, (in_slots, out_slots, edges) in enumerate(plan):
        lp = model.layers[li]
        w_e = rgcn_ops._edge_weights(lp, edge_rel) if edges else None
        last = li == steps - 1

        def term(s, w):
            if s in xs:
                return dtypes.dot_f32(xs[s], w)
            return fused_fwd_ops._rows_by_mode(dtypes.dot_f32(var, w),
                                               node_mode[:, s])

        nxt = {}
        for s in out_slots:
            acc = term(s, lp.w_self)
            for j in edges:
                if spec.edge_dst[j] != s:
                    continue
                msg = term(spec.edge_src[j], w_e[j])
                acc = acc + msg * edge_norm[j].to(msg.dtype)
            acc = (acc + lp.bias).to(cfg.dtype)
            nxt[s] = acc if last else torch.relu(acc)
        xs = nxt
    return xs[spec.target_slot]


def encode_dense(
    model: MPQE,
    cfg: MPQEConfig,
    structure: str,
    node_entity: torch.Tensor,  # [B, n] int
    node_mode: torch.Tensor,  # [B, n] int
    edge_rel: torch.Tensor,  # [n_edges] int
    edge_norm: torch.Tensor,  # [n_edges] float32
    anchor_rows: Optional[torch.Tensor] = None,  # [B, A, d] pre-gathered
) -> torch.Tensor:
    """Embed + message-pass + read out one formula's batch → ``[B, d]``
    in ``cfg.dtype`` (the training encoder of ``--kernel dense``).  TGT runs the
    dead-slot-pruned plan; the other readouts run every layer over every
    slot.  ``anchor_rows`` (columns per :func:`anchor_gather_slots`)
    replaces the entity gather."""
    spec = STRUCTURES[structure]
    steps = num_steps(cfg, structure)
    if cfg.readout == "tgt":
        return _encode_dense_tgt_pruned(model, cfg, spec, node_entity,
                                        node_mode, edge_rel, edge_norm, steps,
                                        anchor_rows=anchor_rows)
    x = emb_mod.embed_nodes_template(model.emb, node_entity, node_mode,
                                     spec.anchor_slots, spec.n_nodes,
                                     anchor_rows=anchor_rows)
    for li in range(steps):
        x = rgcn_ops.rgcn_dense_template(x, model.layers[li], spec.edge_src,
                                         spec.edge_dst, edge_rel, edge_norm
                                         ).to(cfg.dtype)
        if li < steps - 1:
            x = torch.relu(x)
    return readout_mod.readout_dense(cfg.readout, model.readout, x,
                                     spec.target_slot)


class _FusedRecompute(torch.autograd.Function):
    """Forward through K1, gradient by recomputing :func:`encode_dense`
    (``backward="xla"``).  ``apply(run, edge_norm, anchor_rows,
    *params)``; ``run(edge_norm, anchor_rows, fused)`` encodes through K1
    (``fused=True``) or :func:`encode_dense`."""

    @staticmethod
    def forward(ctx, run, edge_norm, anchor_rows, *params):
        ctx.run = run
        ctx.save_for_backward(edge_norm, anchor_rows, *params)
        return run(edge_norm, anchor_rows, True)

    @staticmethod
    def backward(ctx, g):
        edge_norm, anchor_rows, *params = ctx.saved_tensors
        en = edge_norm.detach().requires_grad_(ctx.needs_input_grad[1])
        ar = None if anchor_rows is None else anchor_rows.detach(
        ).requires_grad_(ctx.needs_input_grad[2])
        inputs = [t for t in (en, ar) if t is not None and t.requires_grad]
        inputs += [p for p, need in zip(params, ctx.needs_input_grad[3:])
                   if need]
        with torch.enable_grad():
            q = ctx.run(en, ar, False)
        # the cotangent in the recomputed output's dtype: an out_bf16
        # forward of an f32 model upcasts it; at cfg.dtype = bfloat16 the
        # output and its cotangent are bf16 (the reference's xla backward
        # upcasts it there too, and its vjp then refuses the f32 cotangent)
        grads = iter(torch.autograd.grad(q, inputs, g.to(q.dtype),
                                         allow_unused=True))
        out = [None, next(grads) if en.requires_grad else None,
               next(grads) if ar is not None and ar.requires_grad else None]
        out += [next(grads) if need else None
                for need in ctx.needs_input_grad[3:]]
        return tuple(out)


def encode_dense_fused(
    model: MPQE,
    cfg: MPQEConfig,
    structure: str,
    node_entity: torch.Tensor,  # [B, n] int
    node_mode: torch.Tensor,  # [B, n] int
    edge_rel: torch.Tensor,  # [n_edges] int
    edge_norm: torch.Tensor,  # [n_edges] float32
    anchor_rows=None,  # None | [B, A, d] | sequence of [B, d]
    backward: str = "xla",
    out_bf16: bool = False,
) -> torch.Tensor:
    """:func:`encode_dense` with the forward run by K1
    (:func:`ops.fused_fwd.fused_tgt_forward`, the hand-written CUDA kernel
    on the card).  ``backward`` selects the gradient path:

    * ``"xla"`` (the reference's default; its name is kept for the CLI)
      recomputes through :func:`encode_dense` with autograd, so gradients
      are those of the f32 encoder;
    * ``"pallas"`` (the CLI's name, kept) runs K2, the hand-written CUDA
      backward kernel, and autograd carries its ``dW``/``db``/``dA`` on
      through the differentiable ``_layer_matrices`` and the anchor
      gather into ``emb.ent``.

    ``out_bf16`` has K1 write its output in bf16, returned cast to
    ``cfg.dtype`` (the reference's variant; a bf16 model always takes
    it).  K2 takes the cotangent in f32; the recompute in the dtype of
    :func:`encode_dense`'s output.  The reference's ``block``, ``interpret``,
    ``onehot_operand``, ``split_gemm``, ``vmem_limit_mb`` and
    ``bwd_block`` tile the TPU and have no counterpart.  Requires
    ``readout='tgt'``."""
    if backward == "pallas":
        return fused_fwd_ops._fused_apply(model, cfg, structure, node_entity,
                                          node_mode, edge_rel, edge_norm,
                                          anchor_rows, out_bf16=out_bf16)
    if backward != "xla":
        raise ValueError(f"unknown backward mode {backward!r}")
    if isinstance(anchor_rows, (tuple, list)):
        anchor_rows = torch.stack(list(anchor_rows), dim=1)

    def run(en, ar, fused):
        if fused:
            return fused_fwd_ops.fused_tgt_forward(
                model, cfg, structure, node_entity, node_mode, edge_rel, en,
                ar, out_bf16=out_bf16)
        return encode_dense(model, cfg, structure, node_entity, node_mode,
                            edge_rel, en, anchor_rows=ar)

    params = [p for p in model.parameters()]
    return _FusedRecompute.apply(run, edge_norm, anchor_rows, *params)


def encode_dense_multi(
    model: MPQE,
    cfg: MPQEConfig,
    structure: str,
    node_entity: torch.Tensor,  # [B, n] int
    node_mode: torch.Tensor,  # [B, n] int
    edge_rel_q: torch.Tensor,  # [B, n_edges] int — PER-QUERY relations
    edge_norm_q: torch.Tensor,  # [B, n_edges] float32
) -> torch.Tensor:
    """Dense template forward with per-query relations → ``[B, d]`` in
    ``cfg.dtype`` (f32 products, ``(acc + bias)`` rounded once a layer).

    Basis layers contract basis-first per query (``h_b = x_src @ V_b``,
    then ``sum_b coeff[rel_e, b] h_b``); full-weight layers gather the
    per-query matrices ``w_rel[rel_e]`` and apply a batched matvec.  No
    ReLU after the last layer."""
    spec = STRUCTURES[structure]
    steps = num_steps(cfg, structure)
    if cfg.readout == "tgt":
        plan = _live_slot_plan(spec, steps)
    else:
        all_slots = tuple(range(spec.n_nodes))
        plan = [(all_slots, all_slots, tuple(range(spec.n_edges)))] * steps

    in_slots0 = plan[0][0]
    anchors = set(spec.anchor_slots)
    xs = {}
    for s in in_slots0:
        if s in anchors:
            xs[s] = _entity_rows(model.emb.ent, node_entity[:, s])
        else:
            xs[s] = fused_fwd_ops._rows_by_mode(
                model.emb.var, node_mode[:, s]).to(cfg.dtype)
    edge_norm_q = edge_norm_q.to(torch.float32)
    cur_slots = in_slots0
    for li, (in_slots, out_slots, edges) in enumerate(plan):
        lp = model.layers[li]
        has_basis = lp.basis is not None
        n_rel = (lp.coeff if has_basis else lp.w_rel).shape[0]
        if has_basis:
            src_slots = sorted({spec.edge_src[j] for j in edges})
            h_b = {s: dtypes.einsum_f32("bd,kdo->bko", xs[s], lp.basis)
                   for s in src_slots}
        last = li == steps - 1
        nxt = {}
        for s in out_slots:
            acc = dtypes.dot_f32(xs[s], lp.w_self)
            for j in edges:
                if spec.edge_dst[j] != s:
                    continue
                rel = edge_rel_q[:, j].long().clamp(0, n_rel - 1)
                if has_basis:
                    msg = dtypes.einsum_f32("bk,bko->bo", lp.coeff[rel],
                                            h_b[spec.edge_src[j]])
                else:
                    msg = dtypes.einsum_f32("bd,bdo->bo",
                                            xs[spec.edge_src[j]],
                                            lp.w_rel[rel])
                acc = acc + msg * edge_norm_q[:, j, None]
            acc = (acc + lp.bias).to(cfg.dtype)
            nxt[s] = acc if last else torch.relu(acc)
        xs = nxt
        cur_slots = out_slots
    if cfg.readout == "tgt":
        return xs[spec.target_slot]
    x = torch.stack([xs[s] for s in cur_slots], dim=1)
    return readout_mod.readout_dense(cfg.readout, model.readout, x,
                                     spec.target_slot)


def multi_kernel_eligible(cfg: MPQEConfig, structure: str) -> bool:
    """True when K3 (:func:`ops.fused_fwd.fused_tgt_forward_multi`) can
    encode this (model, structure): TGT readout, basis decomposition and
    a packed variable one-hot.  Unlike the reference there is no backend
    test and no switch: eligible models always take K3 (its plain version
    on the CPU)."""
    if cfg.readout != "tgt" or cfg.num_bases is None:
        return False
    spec = STRUCTURES[structure]
    plan = _live_slot_plan(spec, num_steps(cfg, structure))
    anchors = set(spec.anchor_slots)
    n_var = sum(1 for s in plan[0][0] if s not in anchors)
    d_pad = -(-cfg.embed_dim // 128) * 128
    m8 = -(-max(cfg.n_modes, 1) // 8) * 8
    return cfg.n_modes <= d_pad and n_var * m8 <= d_pad


def encode_dense_multi_auto(
    model: MPQE,
    cfg: MPQEConfig,
    structure: str,
    node_entity: torch.Tensor,
    node_mode: torch.Tensor,
    edge_rel_q: torch.Tensor,
    edge_norm_q: torch.Tensor,
    *,
    operands: Optional[fused_fwd_ops.FusedMultiOperands],
) -> torch.Tensor:
    """Per-query-relation encode through K3 when the model qualifies
    (:func:`multi_kernel_eligible`), else :func:`encode_dense_multi`.
    ``operands``: K3's operands from
    :func:`ops.fused_fwd.prepare_fused_multi`, built once per model
    (``None`` for a model that never qualifies)."""
    if multi_kernel_eligible(cfg, structure):
        return fused_fwd_ops.fused_tgt_forward_multi(
            model, cfg, structure, node_entity, node_mode, edge_rel_q,
            edge_norm_q, operands=operands)
    return encode_dense_multi(model, cfg, structure, node_entity, node_mode,
                              edge_rel_q, edge_norm_q)


def _sparse_encode(model: MPQE, cfg: MPQEConfig, structure: str,
                   node_entity, node_mode, node_is_var, node_query,
                   target_node, n_queries: int, layer,
                   segment_backend: str = "xla",
                   readout_layout=None) -> torch.Tensor:
    """Embed a flat node list, run ``layer(x, layer_params)`` for the
    structure's depth (:func:`_sparse_steps`) with ReLU between layers,
    read out (segment sums and maxima by ``segment_backend``, over
    ``readout_layout`` when given) → ``[n_queries, d]``."""
    x = emb_mod.embed_nodes_sparse(model.emb, node_entity, node_mode,
                                   node_is_var)
    steps = _sparse_steps(cfg, structure)
    for li in range(steps):
        x = layer(x, model.layers[li])
        if li < steps - 1:
            x = torch.relu(x)
    n_tpl = STRUCTURES[structure].n_nodes if structure else None
    return readout_mod.readout_sparse(cfg.readout, model.readout, x,
                                      node_query, target_node, n_queries,
                                      n_template_nodes=n_tpl,
                                      segment_backend=segment_backend,
                                      layout=readout_layout)


def _sparse_steps(cfg: MPQEConfig, structure: str) -> int:
    """Layers a sparse encode runs: the structure's depth, all layers for
    structure ""."""
    return num_steps(cfg, structure) if structure else cfg.n_layers


def encode_sparse(model: MPQE, cfg: MPQEConfig, structure: str,
                  node_entity, node_mode, node_is_var, edge_src, edge_dst,
                  edge_rel, edge_norm, node_query, target_node,
                  n_queries: int, segment_backend: str = "xla"
                  ) -> torch.Tensor:
    """Sparse forward over a flat node and edge list (reference
    ``encode_sparse``): layers of ``rgcn_sparse``.  ``segment_backend=
    "pallas"`` takes every layer's destination sum and the sum, mlp and max
    readouts through K4a / K4b (``ops/segment_kernels.py``), which are
    forward only: call it under ``torch.no_grad()``.  Their layouts are
    built once per call: the destinations' from ``edge_dst`` for all
    layers, the readout's from ``node_query``.  Like the reference's, it
    does not round between layers: a bf16 model's layer 0 takes the bf16
    embeddings, every later layer and the readout the f32 activations
    (its weights widened), and the result is f32."""
    dst_layout = readout_layout = None
    if segment_backend == "pallas":
        if _sparse_steps(cfg, structure):
            dst_layout = segment_kernels.segment_layout(
                edge_dst, node_entity.shape[0])
        if cfg.readout in ("sum", "mlp", "max"):
            readout_layout = segment_kernels.segment_layout(node_query,
                                                            n_queries)
    return _sparse_encode(
        model, cfg, structure, node_entity, node_mode, node_is_var,
        node_query, target_node, n_queries,
        lambda x, lp: rgcn_ops.rgcn_sparse(x, lp, edge_src, edge_dst,
                                           edge_rel, edge_norm, cfg.n_rels,
                                           segment_backend=segment_backend,
                                           layout=dst_layout),
        segment_backend=segment_backend, readout_layout=readout_layout)


def encode_sparse_fused(model: MPQE, cfg: MPQEConfig, structure: str,
                        node_entity, node_mode, node_is_var, chunked,
                        node_query, target_node,
                        n_queries: int) -> torch.Tensor:
    """:func:`encode_sparse` with each layer through K5
    (``ops/rgcn_fused.py:rgcn_sparse_fused``) over a relation-chunked
    edge layout.  Every layer runs over every node (no TGT pruning), and
    its f32 output is rounded to ``cfg.dtype``, as the reference does."""
    from mpqe_tpu_torch.ops import rgcn_fused

    return _sparse_encode(
        model, cfg, structure, node_entity, node_mode, node_is_var,
        node_query, target_node, n_queries,
        lambda x, lp: rgcn_fused.rgcn_sparse_fused(
            x, lp, chunked, cfg.n_rels).to(cfg.dtype))


def encode_sparse_blocked(model: MPQE, cfg: MPQEConfig, structure: str,
                          node_entity, node_mode, node_is_var, bucketed,
                          node_query, target_node,
                          n_queries: int) -> torch.Tensor:
    """:func:`encode_sparse` with each layer through K6
    (``ops/rgcn_blocked.py:rgcn_sparse_blocked``, bf16 products) over a
    (dst block, src block) bucketed layout; basis layers only.  The
    layout's device tensors and edge lists are built once, for all
    layers (or given: the pair ``rgcn_blocked.layouts_on`` returns).
    Each layer's f32 output is rounded to ``cfg.dtype``, as the
    reference does."""
    from mpqe_tpu_torch.ops import rgcn_blocked

    lays = bucketed if isinstance(bucketed, tuple) else \
        rgcn_blocked.layouts_on(bucketed, node_entity.device)
    return _sparse_encode(
        model, cfg, structure, node_entity, node_mode, node_is_var,
        node_query, target_node, n_queries,
        lambda x, lp: rgcn_blocked.rgcn_sparse_blocked(
            x, lp, lays, cfg.n_rels).to(cfg.dtype))


def _sparse_view_on_device(structure: str, node_entity: torch.Tensor,
                           node_mode: torch.Tensor):
    """A dense template batch as the sparse view's node arrays, made on
    the batch's device: ``(node_entity [B n], node_mode [B n],
    node_is_var [B n], node_query [B n], target_node [B], B)``."""
    spec = STRUCTURES[structure]
    B, n = node_entity.shape
    dev = node_entity.device
    is_var = torch.zeros((n,), dtype=torch.float32, device=dev)
    is_var[list(spec.free_slots)] = 1.0
    node_query = torch.div(torch.arange(B * n, dtype=torch.int32,
                                        device=dev), n, rounding_mode="floor")
    target_node = (torch.arange(B, dtype=torch.int32, device=dev) * n
                   + spec.target_slot)
    return (node_entity.reshape(-1), node_mode.reshape(-1),
            is_var.repeat(B), node_query, target_node, B)


def dense_batch_loss_kernel_fused(model: MPQE, cfg: MPQEConfig,
                                  structure: str, node_entity, node_mode,
                                  edge_rel, edge_norm, target, negatives,
                                  neg_mask, query_mask,
                                  chunk: int = 512) -> torch.Tensor:
    """:func:`dense_batch_loss` routed through K5 (``--kernel fused``):
    the batch's relation-chunked layout is made on the device
    (``ops/template_layout.py:template_chunked``) and the encoder is
    :func:`encode_sparse_fused`."""
    from mpqe_tpu_torch.ops import template_layout

    ne_f, nm_f, niv, nq, tn, B = _sparse_view_on_device(
        structure, node_entity, node_mode)
    chunked = template_layout.template_chunked(structure, edge_rel,
                                               edge_norm, B, chunk)
    q = encode_sparse_fused(model, cfg, structure, ne_f, nm_f, niv, chunked,
                            nq, tn, B)
    return margin_loss_from_queries(model, cfg, q, target, negatives,
                                    neg_mask, query_mask)


def dense_batch_loss_kernel_blocked(model: MPQE, cfg: MPQEConfig,
                                    structure: str, node_entity, node_mode,
                                    edge_rel, edge_norm, target, negatives,
                                    neg_mask, query_mask,
                                    queries_per_block: int = 512,
                                    chunk: int = 512) -> torch.Tensor:
    """:func:`dense_batch_loss` routed through K6 (``--kernel blocked``):
    diagonal query-aligned node blocks
    (``ops/template_layout.py:template_blocked_layouts``: the
    ``template_blocked`` layouts with K6's edge lists, their edge orders
    cached per batch geometry) and :func:`encode_sparse_blocked`.
    Requires basis decomposition."""
    from mpqe_tpu_torch.ops import template_layout

    if cfg.num_bases is None:
        raise ValueError("--kernel blocked requires num_bases > 0")
    ne_f, nm_f, niv, nq, tn, B = _sparse_view_on_device(
        structure, node_entity, node_mode)
    lays = template_layout.template_blocked_layouts(
        structure, edge_rel, edge_norm, B,
        queries_per_block=queries_per_block, chunk=chunk)
    q = encode_sparse_blocked(model, cfg, structure, ne_f, nm_f, niv,
                              lays, nq, tn, B)
    return margin_loss_from_queries(model, cfg, q, target, negatives,
                                    neg_mask, query_mask)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def score(cfg: MPQEConfig, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Cosine (or dot) affinity between query vectors ``[..., d]`` and
    candidate entity embeddings of matching shape (f32)."""
    q, cand = q.to(torch.float32), cand.to(torch.float32)
    if cfg.scale_scores:
        q, cand = _l2_normalize(q), _l2_normalize(cand)
    return torch.sum(q * cand, dim=-1)


def score_all_entities(model: MPQE, cfg: MPQEConfig,
                       q: torch.Tensor) -> torch.Tensor:
    """``[B, n_entities]`` f32 affinities — one big matmul (eval sweep),
    the rows normalized in their own dtype, as the reference does."""
    e = model.emb.ent
    if cfg.scale_scores:
        q, e = _l2_normalize(q), _l2_normalize(e)
    return dtypes.dot_f32(q, e.t())


def margin_terms(cfg: MPQEConfig, q: torch.Tensor, pos_rows: torch.Tensor,
                 neg_rows: torch.Tensor, neg_mask: torch.Tensor,
                 query_mask: torch.Tensor):
    """``(sum of relu(margin - s(q, pos) + s(q, neg)) over the real
    (query, negative) pairs, their count)``, from gathered candidate rows
    (``q [B, d]``, ``pos_rows [B, d]``, ``neg_rows [B, K, d]``, masks
    ``[B, K]`` and ``[B]``): the two sums a data-parallel loss adds over
    its parts."""
    pos = score(cfg, q, pos_rows)
    neg = score(cfg, q[:, None, :], neg_rows)
    viol = torch.relu(cfg.margin - pos[:, None] + neg)
    w = neg_mask * query_mask[:, None]
    return torch.sum(viol * w), torch.sum(w)


def margin_loss_from_rows(cfg: MPQEConfig, q: torch.Tensor,
                          pos_rows: torch.Tensor, neg_rows: torch.Tensor,
                          neg_mask: torch.Tensor,
                          query_mask: torch.Tensor) -> torch.Tensor:
    """mean(relu(margin - s(q, pos) + s(q, neg))) over the real (query,
    negative) pairs (:func:`margin_terms`: their sum over their count, at
    least 1)."""
    total, count = margin_terms(cfg, q, pos_rows, neg_rows, neg_mask,
                                query_mask)
    return total / torch.clamp(count, min=1.0)


def margin_loss_from_queries(model: MPQE, cfg: MPQEConfig, q: torch.Tensor,
                             target: torch.Tensor, negatives: torch.Tensor,
                             neg_mask: torch.Tensor,
                             query_mask: torch.Tensor) -> torch.Tensor:
    """:func:`margin_loss_from_rows` with the candidate rows gathered from
    ``emb.ent`` (:func:`models.embeddings.entity_rows`); the gather's
    gradient is a dense ``[n_entities, d]`` tensor, as in the
    reference."""
    ent = model.emb.ent
    return margin_loss_from_rows(cfg, q, _entity_rows(ent, target),
                                 _entity_rows(ent, negatives), neg_mask,
                                 query_mask)


def dense_batch_loss(model: MPQE, cfg: MPQEConfig, structure: str,
                     node_entity, node_mode, edge_rel, edge_norm, target,
                     negatives, neg_mask, query_mask) -> torch.Tensor:
    """Batch margin loss through :func:`encode_dense` (``--kernel
    dense``)."""
    q = encode_dense(model, cfg, structure, node_entity, node_mode, edge_rel,
                     edge_norm)
    return margin_loss_from_queries(model, cfg, q, target, negatives,
                                    neg_mask, query_mask)


def dense_batch_loss_kernel_fused_fwd(model: MPQE, cfg: MPQEConfig,
                                      structure: str, node_entity, node_mode,
                                      edge_rel, edge_norm, target, negatives,
                                      neg_mask, query_mask,
                                      backward: str = "xla") -> torch.Tensor:
    """:func:`dense_batch_loss` with the forward through K1 and the
    gradient by ``backward`` (see :func:`encode_dense_fused`; ``--kernel
    fused_fwd --fused_backward``).  Requires ``readout='tgt'``."""
    q = encode_dense_fused(model, cfg, structure, node_entity, node_mode,
                           edge_rel, edge_norm, None, backward)
    return margin_loss_from_queries(model, cfg, q, target, negatives,
                                    neg_mask, query_mask)


def dense_batch_loss_fused(model: MPQE, cfg: MPQEConfig, structure: str,
                           node_entity, node_mode, edge_rel, edge_norm,
                           target, negatives, neg_mask, query_mask,
                           grad_scatter: str = "dense") -> torch.Tensor:
    """:func:`dense_batch_loss` with one entity-table access: the anchor,
    target and negative rows in one :func:`ops.embed.embedding_lookup`,
    whose gradient is summed by ``grad_scatter`` (``dense``, ``sorted``
    or ``dedup``).  The same value as :func:`dense_batch_loss`."""
    a_slots = list(anchor_gather_slots(cfg, structure))
    n_a = len(a_slots)
    idx = torch.cat([node_entity[:, a_slots], target[:, None], negatives],
                    dim=1)
    rows = embed_ops.embedding_lookup(model.emb.ent, idx, grad_scatter)
    q = encode_dense(model, cfg, structure, node_entity, node_mode,
                     edge_rel, edge_norm, anchor_rows=rows[:, :n_a, :])
    return margin_loss_from_rows(cfg, q, rows[:, n_a, :],
                                 rows[:, n_a + 1:, :], neg_mask, query_mask)


def dense_batch_loss_shared_negs(
    model: MPQE,
    cfg: MPQEConfig,
    structure: str,
    node_entity: torch.Tensor,
    node_mode: torch.Tensor,
    edge_rel: torch.Tensor,
    edge_norm: torch.Tensor,
    target: torch.Tensor,  # [B]
    shared_negatives: torch.Tensor,  # [K]: ONE negative set for the batch
    query_mask: torch.Tensor,  # [B]
    encoder: str = "dense",
    fused_backward: str = "xla",
    self_adv_tau: float = 0.0,
) -> torch.Tensor:
    """Margin loss with batch-shared negatives (a protocol variant):
    every query is scored against one set of K candidates, so the table
    rows read per batch drop from ``B (anchors + 1 + K)`` to ``B (anchors
    + 1) + K`` and the negative scores are one ``[B, d] @ [d, K]``
    product (f32 results of f32 operands).

    ``encoder`` is ``"dense"`` (:func:`encode_dense`) or ``"fused_fwd"``
    (:func:`encode_dense_fused`: K1, with ``fused_backward`` ``"xla"`` or
    ``"pallas"``: K2).  A candidate equal to a query's target is masked
    out of that query's terms.  ``self_adv_tau > 0`` weights each query's
    violations by ``softmax(tau * score)`` over its live candidates, the
    weights detached (self-adversarial sampling, arXiv:1902.10197 §3.1);
    a row with no live candidate (a padded query) contributes nothing and
    no NaN."""
    a_slots = list(anchor_gather_slots(cfg, structure))
    n_a = len(a_slots)
    idx = torch.cat([node_entity[:, a_slots], target[:, None]], dim=1)
    rows = embed_ops.embedding_lookup(model.emb.ent, idx)
    anchor_rows = rows[:, :n_a, :]
    pos_rows = rows[:, n_a, :]
    neg_rows = embed_ops.embedding_lookup(model.emb.ent, shared_negatives)
    if encoder == "fused_fwd":
        q = encode_dense_fused(model, cfg, structure, node_entity, node_mode,
                               edge_rel, edge_norm, anchor_rows,
                               fused_backward)
    elif encoder == "dense":
        q = encode_dense(model, cfg, structure, node_entity, node_mode,
                         edge_rel, edge_norm, anchor_rows=anchor_rows)
    else:
        raise ValueError(f"unknown encoder {encoder!r}")
    qf = q.to(torch.float32)
    nf = neg_rows.to(torch.float32)
    if cfg.scale_scores:
        qf, nf = _l2_normalize(qf), _l2_normalize(nf)
    pos = score(cfg, q, pos_rows)  # [B]
    neg = dtypes.dot_f32(qf, nf.t())  # [B, K]
    viol = torch.relu(cfg.margin - pos[:, None] + neg)
    not_self = shared_negatives[None, :] != target[:, None]
    w = query_mask[:, None] * not_self.to(viol.dtype)
    if self_adv_tau > 0.0:
        live = w > 0
        logits = torch.where(live, self_adv_tau * neg,
                             torch.full_like(neg, float("-inf")))
        has_live = torch.sum(w, dim=1) > 0
        p_adv = torch.softmax(
            torch.where(has_live[:, None], logits, torch.zeros_like(logits)),
            dim=1).detach()
        per_q = torch.sum(torch.where(live, p_adv * viol,
                                      torch.zeros_like(viol)), dim=1)
        live_q = has_live.to(viol.dtype) * query_mask
        return torch.sum(per_q * live_q) / torch.clamp(torch.sum(live_q),
                                                       min=1.0)
    return torch.sum(viol * w) / torch.clamp(torch.sum(w), min=1.0)


def make_shared_negs_batch_loss(n_shared: int, encoder: str = "dense",
                                fused_backward: str = "xla",
                                self_adv_tau: float = 0.0):
    """:func:`dense_batch_loss_shared_negs` behind the training loop's
    ``batch_loss_fn`` signature (``train --shared_negatives K``).  The
    shared set is drawn from the batch's own negatives: the first
    negative of ``min(K, B)`` donor queries strided across the batch; a
    padded donor (``query_mask == 0``) gives the first query's
    negative instead."""
    if n_shared <= 0:
        raise ValueError("n_shared must be positive")

    def fn(model, cfg, structure, node_entity, node_mode, edge_rel,
           edge_norm, target, negatives, neg_mask, query_mask):
        bsz = negatives.shape[0]
        k = min(n_shared, bsz)
        donors = (torch.arange(k, device=negatives.device)
                  * max(bsz // k, 1)) % bsz
        cand = negatives[donors, 0]
        shared = torch.where(query_mask[donors] > 0, cand, negatives[0, 0])
        return dense_batch_loss_shared_negs(
            model, cfg, structure, node_entity, node_mode, edge_rel,
            edge_norm, target, shared, query_mask, encoder=encoder,
            fused_backward=fused_backward, self_adv_tau=self_adv_tau)

    return fn
