"""Training through the edge-partitioned halo layers (counterpart of
``mpqe_tpu/parallel/halo_train.py``).

The train step's forward runs the distributed R-GCN of
``parallel/halo.py`` — ``rgcn_ring_halo`` (the ``ppermute`` ring) or
``rgcn_dst_partitioned`` (the ``all_gather`` halo) — and its backward is
autograd through the per-part lists and their copies
(``parallel/mesh.py``).  Selected by ``python -m mpqe_tpu_torch.train
--parallel halo_ring`` / ``--parallel halo_gather``; with
``--steps_per_call K`` each call takes K steps
(:func:`make_halo_multistep_train_step`).

For dense template batches the batched query graph's edge endpoints are
a static function of (structure, batch size): B tiled copies of the
template.  The (dst block, src block) partition is therefore made once in
numpy and cached on the device (:func:`_template_layout`); only the
formula's per-edge relations and norms are placed into it per step.
Parameters are replicated: the model lives on the mesh's first device and
each part copies what it needs.

On a mesh that spans processes (``multihost.global_mesh``, as the
reference's worker feeds ``make_mesh((8, 1))`` over two processes) every
process holds the whole model on its first device and the whole
(replicated) batch, computes its own parts of each layer and the same
whole loss; the layers' backward sums the processes' parameter gradients
(``parallel/mesh.py enter_parts``), so the optimizer steps on gradients,
and parameters, that are equal in every process.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

from mpqe_tpu_torch.models import embeddings as emb_mod
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.models import readout as readout_mod
from mpqe_tpu_torch.parallel import halo
from mpqe_tpu_torch.parallel import mesh as mesh_lib
from mpqe_tpu_torch.parallel.mesh import Mesh
from mpqe_tpu_torch.queries import STRUCTURES
from mpqe_tpu_torch.train import loop as loop_mod


def _template_layout_np(structure: str, batch_size: int, n_parts: int,
                        layer_kind: str) -> Dict:
    """The partition layout of B template copies, in numpy: where each
    tiled template edge lands in the ``[P(, P), e_max]`` buckets, the
    padded node count and the per-node metadata."""
    spec = STRUCTURES[structure]
    B, n = batch_size, spec.n_nodes
    N = B * n
    block = -(-N // n_parts)
    n_pad = n_parts * block

    offs = np.arange(B, dtype=np.int64)[:, None] * n
    src = (offs + np.asarray(spec.edge_src)[None, :]).reshape(-1)
    dst = (offs + np.asarray(spec.edge_dst)[None, :]).reshape(-1)
    dp, sp = dst // block, src // block

    if layer_kind == "ring":
        key = dp * n_parts + sp
        n_buckets = n_parts * n_parts
        src_local = src - sp * block
    else:  # dst-partitioned all_gather halo: global src, local dst
        key = dp
        n_buckets = n_parts
        src_local = src
    counts = np.bincount(key, minlength=n_buckets)
    e_max = max(int(counts.max()), 1)
    e_max = ((e_max + 7) // 8) * 8
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    starts = np.zeros(n_buckets, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    flat = key_s * e_max + (np.arange(key_s.size) - starts[key_s])

    total = n_buckets * e_max
    o_src = np.zeros(total, np.int32)
    o_dst = np.full(total, block, np.int32)  # out of block range: dropped
    o_src[flat] = src_local[order]
    o_dst[flat] = (dst - dp * block)[order]

    is_var = np.zeros((n,), np.float32)
    for s in spec.free_slots:
        is_var[s] = 1.0
    node_is_var = np.zeros(n_pad, np.float32)
    node_is_var[:N] = np.tile(is_var, B)
    node_query = np.full(n_pad, batch_size, np.int32)  # pad -> dropped
    node_query[:N] = np.repeat(np.arange(B, dtype=np.int32), n)
    target_node = (np.arange(B, dtype=np.int32) * n
                   + np.int32(spec.target_slot))
    # edge slot id of each tiled edge (to look up the formula's rel/norm)
    slot = np.tile(np.arange(spec.n_edges, dtype=np.int64), B)

    shape = ((n_parts, n_parts, e_max) if layer_kind == "ring"
             else (n_parts, e_max))
    return dict(
        spec=spec, n_pad=n_pad, block=block, total=total, shape=shape,
        flat=flat, slot_ordered=slot[order], o_src=o_src, o_dst=o_dst,
        node_is_var=node_is_var, node_query=node_query,
        target_node=target_node,
    )


@functools.lru_cache(maxsize=None)
def _template_layout(structure: str, batch_size: int, n_parts: int,
                     layer_kind: str, device: torch.device) -> Dict:
    """:func:`_template_layout_np` with its arrays on ``device``, made once
    per (structure, B, P, kind, device)."""
    lay = {k: (torch.from_numpy(v).to(device)
               if isinstance(v, np.ndarray) else v)
           for k, v in _template_layout_np(structure, batch_size, n_parts,
                                           layer_kind).items()}
    lay["o_src"] = lay["o_src"].reshape(lay["shape"])
    lay["o_dst"] = lay["o_dst"].reshape(lay["shape"])
    return lay


def halo_dense_batch_loss(
    model: mpqe_mod.MPQE,
    cfg: mpqe_mod.MPQEConfig,
    mesh: Mesh,
    layer_kind: str,  # "ring" | "gather"
    structure: str,
    node_entity: torch.Tensor,  # [B, n]
    node_mode: torch.Tensor,
    edge_rel: torch.Tensor,  # [n_edges]
    edge_norm: torch.Tensor,
    target: torch.Tensor,
    negatives: torch.Tensor,
    neg_mask: torch.Tensor,
    query_mask: torch.Tensor,
    axis: str = "data",
) -> torch.Tensor:
    """Same math as ``mpqe.dense_batch_loss`` with the message passing run
    by the edge-partitioned layers over ``mesh``'s ``axis``.  The
    embeddings and each layer's f32 output are rounded to ``cfg.dtype``,
    as the reference's ``halo_dense_batch_loss`` rounds them."""
    if layer_kind not in ("ring", "gather"):
        raise ValueError(f"layer_kind {layer_kind!r}: 'ring' or 'gather'")
    B, n = node_entity.shape
    dev = node_entity.device
    lay = _template_layout(structure, B, mesh.shape[axis], layer_kind, dev)
    n_pad = lay["n_pad"]
    N = B * n
    pad = torch.zeros(n_pad - N, dtype=torch.int32, device=dev)
    ne = torch.cat([node_entity.reshape(N).to(torch.int32), pad])
    nm = torch.cat([node_mode.reshape(N).to(torch.int32), pad])
    x = emb_mod.embed_nodes_sparse(model.emb, ne, nm,
                                   lay["node_is_var"]).to(cfg.dtype)

    # place the formula's per-edge rel/norm into the static layout
    flat, slot = lay["flat"], lay["slot_ordered"]
    rel_p = torch.full((lay["total"],), cfg.n_rels, dtype=torch.int32,
                       device=dev).index_put(
        (flat,), edge_rel[slot].to(torch.int32))
    norm_p = torch.zeros((lay["total"],), dtype=torch.float32,
                         device=dev).index_put(
        (flat,), edge_norm[slot].to(torch.float32))
    shape = lay["shape"]
    args = (lay["o_src"], lay["o_dst"], rel_p.reshape(shape),
            norm_p.reshape(shape), cfg.n_rels)
    layer_fn = (halo.rgcn_ring_halo if layer_kind == "ring"
                else halo.rgcn_dst_partitioned)
    steps = mpqe_mod.num_steps(cfg, structure)
    # across processes the layers' crossings run their backward
    # exchanges in one order in every process (parallel/mesh.py)
    with mesh_lib.ordered_crossings():
        for li in range(steps):
            x = layer_fn(mesh, model.layers[li], x, *args, axis=axis).to(
                cfg.dtype)
            if li < steps - 1:
                x = torch.relu(x)

    q = readout_mod.readout_sparse(
        cfg.readout, model.readout, x, lay["node_query"],
        lay["target_node"], B, n_template_nodes=lay["spec"].n_nodes)
    return mpqe_mod.margin_loss_from_queries(
        model, cfg, q, target, negatives, neg_mask, query_mask)


def halo_batch_loss_fn(mesh: Mesh, layer_kind: str = "ring",
                       axis: str = "data") -> Callable:
    """``batch_loss_fn(model, cfg, structure, *batch tensors)`` through the
    halo layers, for ``train/loop.py`` (``make_train_step``,
    ``run_train``)."""
    def loss_fn(model, cfg, structure, *arrays):
        return halo_dense_batch_loss(model, cfg, mesh, layer_kind,
                                     structure, *arrays, axis=axis)

    return loss_fn


def make_halo_train_step(cfg: mpqe_mod.MPQEConfig,
                         optimizer: loop_mod.OptaxAdam, mesh: Mesh,
                         layer_kind: str = "ring",
                         axis: str = "data") -> Callable:
    """Drop-in for ``loop.make_train_step`` whose forward and backward run
    through the distributed halo layers (the batch itself stays whole;
    node features split over ``axis`` inside the loss)."""
    return loop_mod.make_train_step(
        cfg, optimizer,
        batch_loss_fn=halo_batch_loss_fn(mesh, layer_kind, axis))


def make_halo_multistep_train_step(cfg: mpqe_mod.MPQEConfig,
                                   optimizer: loop_mod.OptaxAdam,
                                   mesh: Mesh, layer_kind: str = "ring",
                                   axis: str = "data") -> Callable:
    """K halo train steps per call over batch tensors with a leading
    ``[K]`` axis: ``loop.make_multistep_train_step`` (the losses stay on
    the device until the caller reads them) with each step's forward and
    backward through the halo layers."""
    return loop_mod.make_multistep_train_step(
        cfg, optimizer,
        batch_loss_fn=halo_batch_loss_fn(mesh, layer_kind, axis))


def init_halo_train_state(gen: torch.Generator, cfg, tc: loop_mod.TrainConfig,
                          mesh: Mesh,
                          shard_entity_table: bool = False
                          ) -> loop_mod.TrainState:
    """A fresh model and optimizer with replicated parameters: node
    activations, not parameters, are what the halo layers split.  The
    model lives on the mesh's first device.  ``shard_entity_table=True``
    row-shards the entity table over the mesh's model axis
    (``parallel/sharding.py``): the halo loss reads it only outside the
    halo layers (the embedding lookup and the loss's candidate rows,
    through the table accessor), and the layer weights stay
    replicated.  On a mesh that spans processes the model lives on this
    process's first device."""
    if not shard_entity_table:
        return loop_mod.init_train_state(gen, cfg, tc,
                                         device=mesh.local_devices()[0])
    from mpqe_tpu_torch.parallel import spmd

    return spmd.init_spmd_train_state(gen, cfg, tc, mesh,
                                      shard_entity_table=True,
                                      shard_relations=False)
