"""The data-parallel train step over a ``(data, model)`` mesh with the
entity table row-sharded (counterpart of ``mpqe_tpu/parallel/spmd.py``;
``python -m mpqe_tpu_torch.train --parallel spmd``).

The reference jits the dense train step under GSPMD and lets XLA place
the collectives.  Here one controller runs the parts itself:

  DP — the batch's ``[B, ...]`` arrays split over the data-axis devices
       (:func:`put_batch`); each part encodes and scores its share on its
       own device, with the replicated parameters copied there (autograd
       goes through the copies, and the copies' gradients are summed in
       part order, as ``mesh.psum`` adds);
  TP — the entity table row-sharded over the model axis
       (``sharding.RowShardedTable``): every part gathers its anchor,
       target and negative rows from their owner blocks, and the rows'
       gradients go back to their owners;
  EP — with ``shard_relations``, each layer's ``coeff`` / ``w_rel``
       row-sharded the same way.

The loss is the reference's ``dense_batch_loss`` over the global batch:
the parts' sums of violations over the global count of real (query,
negative) pairs (not the mean of the parts' means: parts differ in real
queries under ``query_mask``).  The optimizer updates every leaf where
it lives; the global-norm clip sums over every block, and a sharded
leaf's Adam moments are sharded like it.

Under a ``torch.distributed`` process group (``parallel/multihost.py``)
the mesh is each process's own and its batch the process's slice of the
global batch (``multihost.host_local_batch``): the count of real pairs,
the gradients and the loss are summed across processes
(``all_reduce``), so each process takes one process's step over the
global batch and the parameters stay equal across processes.  Only
``all_reduce`` and ``broadcast`` are used: under NCCL with a card a
process, or under gloo (which takes CUDA tensors for those two) for
processes that share a card.  Run on one H100 (gloo, two processes),
on two H100s (NCCL, a card a process) and in one process over four
H100s, which adds the data parts' gradients in part order, as it does
over parts of one card (bit-equal to it there).

The route is the plain dense loss (``models/mpqe.py encode_dense``), as
the reference's is XLA's: no hand-written kernel is reached in this
training step (K3 runs in its validation sweep, from a compact anchor
table).
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from mpqe_tpu_torch.data.batcher import DenseQueryBatch
from mpqe_tpu_torch.models import embeddings as emb_mod
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.parallel import mesh as mesh_lib
from mpqe_tpu_torch.parallel import multihost
from mpqe_tpu_torch.parallel import sharding as sharding_lib
from mpqe_tpu_torch.parallel.mesh import Mesh
from mpqe_tpu_torch.train import loop as loop_mod

# model -> the optimizer its init_fn made (the reference's step takes the
# optimizer state as an argument; the port's takes the model and finds
# its optimizer here)
_OPTIMIZERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _Replicate(torch.autograd.Function):
    """``apply(devices, *params)`` -> a copy of every parameter on every
    device (part-major); the gradients of a parameter's copies are summed
    in part order onto its device."""

    @staticmethod
    def forward(ctx, devices, *params):
        ctx.set_materialize_grads(False)
        ctx.n = len(params)
        ctx.devices = [p.device for p in params]
        return tuple(p.detach().to(dev, copy=True)
                     for dev in devices for p in params)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for i, dev in enumerate(ctx.devices):
            acc = None
            for g in grads[i::ctx.n]:
                if g is None:
                    continue
                acc = g.to(dev) if acc is None else acc + g.to(dev)
            out.append(acc)
        return (None, *out)


def _replicas(model: nn.Module, devices) -> List[Dict[str, torch.Tensor]]:
    """Per part, its copies of the model's replicated parameters by name
    (the row-sharded tables stay where they are)."""
    in_tables = {id(p) for m in model.modules()
                 if isinstance(m, sharding_lib.RowShardedTable)
                 for p in m.parameters()}
    named = [(n, p) for n, p in model.named_parameters()
             if id(p) not in in_tables]
    copies = _Replicate.apply(devices, *(p for _, p in named))
    k = len(named)
    return [{n: copies[i * k + j] for j, (n, _) in enumerate(named)}
            for i in range(len(devices))]


class _Call(nn.Module):
    """``forward(fn, *args) = fn(model, *args)``, so that
    ``torch.func.functional_call`` runs a function of the model with its
    parameters swapped for a part's copies."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


def _part_terms(model, cfg, structure, node_entity, node_mode, edge_rel,
                edge_norm, target, negatives, neg_mask, query_mask):
    """One part's ``(sum of violations, count of real pairs)``: the dense
    encoder and the candidate rows through the table accessor."""
    q = mpqe_mod.encode_dense(model, cfg, structure, node_entity, node_mode,
                              edge_rel, edge_norm)
    ent = model.emb.ent
    return mpqe_mod.margin_terms(cfg, q, emb_mod.entity_rows(ent, target),
                                 emb_mod.entity_rows(ent, negatives),
                                 neg_mask, query_mask)


def _parts(mesh: Mesh, name: str, value) -> List[torch.Tensor]:
    """A batch field as per-part tensors (given so, or split here)."""
    if isinstance(value, (list, tuple)):
        return list(value)
    return sharding_lib.shard_dense_batch_arrays(mesh, **{name: value})[name]


def spmd_dense_batch_loss(model: nn.Module, cfg, mesh: Mesh, structure: str,
                          *fields) -> torch.Tensor:
    """``dense_batch_loss`` over the global batch, each data part on its
    device.  ``fields`` in ``sharding.DENSE_BATCH_FIELDS`` order, each
    a tensor (split here) or a per-part list (:func:`put_batch`).  Under
    a process group the count of real pairs is the global one, and the
    value is this process's share of the loss (the step sums them)."""
    devices = mesh.axis_devices(mesh_lib.data_axis(mesh))
    parts = [_parts(mesh, n, v)
             for n, v in zip(sharding_lib.DENSE_BATCH_FIELDS, fields)]
    reps = _replicas(model, devices)
    call = _Call(model)
    totals, counts = [], []
    for p in range(len(devices)):
        args = {f"model.{n}": t for n, t in reps[p].items()}
        total, count = torch.func.functional_call(
            call, args, (_part_terms, cfg, structure,
                         *(f[p] for f in parts)), strict=False)
        totals.append(total)
        counts.append(count)
    dev = devices[0]
    total = totals[0].to(dev)
    count = counts[0].detach().to(dev)
    for t, c in zip(totals[1:], counts[1:]):
        total = total + t.to(dev)
        count = count + c.detach().to(dev)
    if multihost.process_count() > 1:
        import torch.distributed as dist

        dist.all_reduce(count)
    return total / torch.clamp(count, min=1.0)


def _reduce_across_processes(model: nn.Module) -> Callable:
    """``reduce_grads`` of ``loop.make_train_step``: under a process group
    every gradient and the loss summed across processes; else nothing."""
    def reduce(loss: torch.Tensor) -> torch.Tensor:
        if multihost.process_count() == 1:
            return loss
        import torch.distributed as dist

        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(p.grad)
        loss = loss.clone()
        dist.all_reduce(loss)
        return loss

    return reduce


def spmd_batch_loss_fn(mesh: Mesh) -> Callable:
    """``batch_loss_fn(model, cfg, structure, *fields)`` of
    :func:`spmd_dense_batch_loss` over ``mesh`` (``train/loop.py``)."""
    def loss_fn(model, cfg, structure, *fields):
        return spmd_dense_batch_loss(model, cfg, mesh, structure, *fields)

    return loss_fn


def init_spmd_train_state(gen: torch.Generator, cfg, tc: loop_mod.TrainConfig,
                          mesh: Mesh, shard_entity_table: bool = True,
                          shard_relations: bool = False
                          ) -> loop_mod.TrainState:
    """A fresh model (``init_mpqe`` from ``gen`` on the mesh's first
    device, as the single-device state draws it) placed on ``mesh`` by
    ``sharding.shard_params``, and its optimizer over
    ``sharding.logical_parameters``.  Under a process group every
    parameter is then broadcast from process 0."""
    model = mpqe_mod.init_mpqe(gen, cfg, device=mesh.devices.flat[0])
    return place_train_state(model, tc, mesh,
                             shard_entity_table=shard_entity_table,
                             shard_relations=shard_relations)


def place_train_state(model: nn.Module, tc: loop_mod.TrainConfig,
                      mesh: Mesh, **shard_kw) -> loop_mod.TrainState:
    """:func:`init_spmd_train_state` for a given (unsharded) model, placed
    in place."""
    sharding_lib.shard_params(model, mesh, **shard_kw)
    if multihost.process_count() > 1:
        import torch.distributed as dist

        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p.data, src=0)
    optimizer = loop_mod.make_optimizer(
        tc, sharding_lib.logical_parameters(model))
    _OPTIMIZERS[model] = optimizer
    return loop_mod.TrainState(model=model, optimizer=optimizer)


def _optimizer_of(model: nn.Module):
    try:
        return _OPTIMIZERS[model]
    except KeyError:
        raise ValueError("the model was not placed by an spmd init_fn "
                         "(init_spmd_train_state / place_train_state)"
                         ) from None


def make_spmd_train_step(cfg, tc: loop_mod.TrainConfig, mesh: Mesh,
                         shard_entity_table: bool = True,
                         shard_relations: bool = False
                         ) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)``: ``init_fn(gen)`` -> a ``loop.TrainState``
    placed on ``mesh`` (:func:`init_spmd_train_state`); ``step_fn(model,
    structure, *batch fields) -> loss`` takes one step of such a model
    with the optimizer its init made (fields as tensors or as
    :func:`put_batch` gives them).  ``tc`` is the optimizer's (the
    reference builds its optimizer from it too)."""
    init_fn = functools.partial(init_spmd_train_state, cfg=cfg, tc=tc,
                                mesh=mesh,
                                shard_entity_table=shard_entity_table,
                                shard_relations=shard_relations)
    loss_fn = spmd_batch_loss_fn(mesh)

    def step_fn(model, structure, *fields):
        step = loop_mod.make_train_step(
            cfg, _optimizer_of(model), batch_loss_fn=loss_fn,
            reduce_grads=_reduce_across_processes(model))
        return step(model, structure, *fields)

    return init_fn, step_fn


def put_batch(mesh: Mesh, batch: DenseQueryBatch) -> List[List[torch.Tensor]]:
    """The batch's fields (``loop.BATCH_FIELDS`` order) as per-part lists
    on the data-axis devices (``sharding.shard_dense_batch_arrays``); a
    batch stacked for K steps (``[K, B, ...]``) splits along its second
    axis."""
    axis = batch.node_entity.ndim - 2
    arrays = sharding_lib.shard_dense_batch_arrays(
        mesh, axis=axis, **{f: getattr(batch, f)
                            for f in sharding_lib.DENSE_BATCH_FIELDS})
    return [arrays[f] for f in sharding_lib.DENSE_BATCH_FIELDS]


def spmd_train_step(step_fn: Callable, state: loop_mod.TrainState,
                    mesh: Mesh, batch: DenseQueryBatch) -> float:
    """One step of ``step_fn`` on ``batch`` placed by :func:`put_batch`;
    returns the loss."""
    return loop_mod.run_step(step_fn, state, batch,
                             functools.partial(put_batch, mesh))


def make_spmd_multistep_train_step(cfg, tc: loop_mod.TrainConfig,
                                   mesh: Mesh,
                                   shard_entity_table: bool = True,
                                   shard_relations: bool = False
                                   ) -> Tuple[Callable, Callable]:
    """:func:`make_spmd_train_step` taking K steps a call
    (``loop.make_multistep_train_step``): ``step_fn(model, structure,
    *fields with a leading [K] axis) -> losses [K]``, fields as
    :func:`put_batch` gives a stack of K batches (``loop.run_multistep``
    with ``put_batch``)."""
    init_fn, _ = make_spmd_train_step(cfg, tc, mesh, shard_entity_table,
                                      shard_relations)
    loss_fn = spmd_batch_loss_fn(mesh)

    def step_fn(model, structure, *stacked):
        step = loop_mod.make_multistep_train_step(
            cfg, _optimizer_of(model), batch_loss_fn=loss_fn,
            reduce_grads=_reduce_across_processes(model))
        return step(model, structure, *stacked)

    return init_fn, step_fn
