"""Placement of parameters and batches on the ``(data, model)`` mesh
(counterpart of ``mpqe_tpu/parallel/sharding.py``).

The reference states its layouts as ``NamedSharding`` s and lets GSPMD
insert the collectives.  The port has no ``NamedSharding``: one
controller places each tensor itself, and the one layout the reference
spreads over the mesh, row sharding over the ``model`` axis, is a module
of its own, :class:`RowShardedTable`:

  * rows are padded with zeros to a multiple of the model-axis size and
    block p (``ceil(n / s)`` rows) lives on the mesh's model-axis device
    p, as a parameter of its own (optimizer moments follow the blocks);
  * :meth:`RowShardedTable.rows` gathers by id: each row comes from its
    owner block onto the caller's device, and autograd sends each row's
    gradient back into its owner block.  An id at or past the row count
    reads the padded table (a zero pad row, ids past the padding clamped
    to its last row), as the reference's sharded gathers read theirs;
    negative ids clamp to 0;
  * a state dict holds the table whole, ``[n, ...]`` without the pad
    rows, under the parameter's own name (``emb.ent``), exactly as an
    unsharded model writes it, and loading one splits it again.  That
    write is the one place where the whole table is assembled on one
    device.

:func:`shard_params` applies the reference's policy to a model in place:
``shard_entity_table`` row-shards ``emb.ent``, ``shard_relations`` each
layer's ``coeff`` / ``w_rel``; every other parameter is replicated on the
mesh's first device (the data-parallel step copies it to each part).
Batches split their ``[B, ...]`` arrays over the data-axis devices, with
``edge_rel`` / ``edge_norm`` replicated (:func:`shard_dense_batch_arrays`).

A sharded model's optimizer takes its parameters in the unsharded order
(:func:`logical_parameters`); :func:`optimizer_state_dict` and
:func:`load_optimizer_state_dict` convert its state to and from the
unsharded layout, so a checkpoint of a sharded run is read by the
unsharded code and a sharded run resumes from either.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mpqe_tpu_torch.parallel import mesh as mesh_lib
from mpqe_tpu_torch.parallel.mesh import Mesh


class RowShardedTable(nn.Module):
    """A ``[n, ...]`` table split by rows into ``len(devices)`` blocks of
    ``ceil(n / s)`` rows, block p a parameter on ``devices[p]``, the rows
    past ``n`` zero.  ``shape``, ``dtype`` and ``device`` (block 0's) are
    those of the table it stands for."""

    def __init__(self, table: torch.Tensor, devices: Sequence,
                 requires_grad: bool = True):
        super().__init__()
        devices = [torch.device(d) for d in devices]
        n = table.shape[0]
        per = block_rows(n, len(devices))
        with torch.no_grad():
            self.blocks = nn.ParameterList(
                nn.Parameter(b.to(dev).clone(), requires_grad=requires_grad)
                for b, dev in zip(split_rows(table.detach(), per,
                                             len(devices)), devices))
        self.n_rows = n
        self.block_rows = per
        self._register_state_dict_hook(_whole_state)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.n_rows,) + tuple(self.blocks[0].shape[1:]))

    @property
    def n_padded(self) -> int:
        return self.block_rows * len(self.blocks)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def devices(self) -> List[torch.device]:
        return [b.device for b in self.blocks]

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]`` on ``ids``' device, each row from its owner
        block (see the module doc for ids out of range).  Every block
        gathers at the ids clamped into its range, and the owner's rows
        are kept: no host synchronisation, and the other blocks'
        gradients are zero."""
        dev = ids.device
        ids = ids.long().clamp(0, self.n_padded - 1)
        out = None
        for p, blk in enumerate(self.blocks):
            lo = p * self.block_rows
            local = (ids - lo).clamp(0, self.block_rows - 1)
            r = blk[local.to(blk.device)].to(dev)
            if out is None:
                out = r
                continue
            owned = ids >= lo
            out = torch.where(owned.view(owned.shape + (1,) * (r.dim()
                                                               - ids.dim())),
                              r, out)
        return out

    __getitem__ = rows

    def full(self) -> torch.Tensor:
        """The whole table (pad rows dropped) on block 0's device: for a
        checkpoint write, nothing else."""
        dev = self.device
        return torch.cat([b.detach().to(dev) for b in self.blocks]
                         )[:self.n_rows]

    def compact(self, node_entity: torch.Tensor, slots: Sequence[int]):
        """``(rows, node_entity')`` for a kernel that gathers its rows
        itself from one table: the rows at ``node_entity[:, slots]``
        gathered onto its device as a ``[B * len(slots), ...]`` table,
        and a copy of ``node_entity`` whose ``slots`` hold row numbers
        in it (query b's k-th slot is row ``b * len(slots) + k``)."""
        slots = list(slots)
        B = node_entity.shape[0]
        rows = self.rows(node_entity[:, slots].reshape(-1))
        ne = node_entity.clone()
        ne[:, slots] = torch.arange(B * len(slots), dtype=ne.dtype,
                                    device=ne.device).view(B, len(slots))
        return rows.contiguous(), ne


def _whole_state(module, state_dict, prefix, local_metadata):
    """State-dict hook: the blocks' keys replaced by the whole table under
    the table's own name."""
    for i in range(len(module.blocks)):
        state_dict.pop(f"{prefix}blocks.{i}", None)
    state_dict[prefix[:-1]] = module.full()


def attach_table(owner: nn.Module, leaf: str, table: RowShardedTable) -> None:
    """Put ``table`` in the place of ``owner``'s parameter ``leaf``.  The
    owner's load pre-hook turns a whole table under the parameter's name
    into the blocks' keys (torch hands a child module only the keys
    under its own prefix, so the table cannot see its name itself)."""
    delattr(owner, leaf)
    setattr(owner, leaf, table)
    owner._register_load_state_dict_pre_hook(
        functools.partial(_split_state, leaf=leaf), with_module=True)


def _split_state(owner, state_dict, prefix, local_metadata, strict,
                 missing_keys, unexpected_keys, error_msgs, leaf: str):
    """Load pre-hook of a table's owner: a whole table under the table's
    name becomes the blocks' keys (padded with zero rows)."""
    key = prefix + leaf
    table = getattr(owner, leaf)
    if key not in state_dict or not isinstance(table, RowShardedTable):
        return
    full = state_dict.pop(key)
    if tuple(full.shape) != tuple(table.shape):
        error_msgs.append(f"size mismatch for {key}: copying a param with "
                          f"shape {tuple(full.shape)}, the table is "
                          f"{tuple(table.shape)}")
        return
    for i, b in enumerate(_blocks_of(full, table)):
        state_dict[f"{key}.blocks.{i}"] = b


def block_rows(n: int, s: int, multiple: int = 1) -> int:
    """Rows of each of the ``s`` blocks of an ``n``-row table:
    ``ceil(n / s)`` rounded up to a multiple of ``multiple``, at least
    1.  The one rule of the row layout (the encode table's blocks and the
    sharded ranking's)."""
    per = -(-n // s)
    return max(-(-per // multiple) * multiple, 1)


def split_rows(full: torch.Tensor, per: int, s: int):
    """``full`` padded with zero rows to ``per * s`` and split into ``s``
    blocks of ``per`` rows."""
    pad = per * s - full.shape[0]
    if pad:
        full = torch.cat([full, full.new_zeros((pad,) + tuple(full.shape[1:]))])
    return full.split(per)


def _blocks_of(full: torch.Tensor, table: RowShardedTable):
    """``full`` padded with zero rows and split like ``table``'s blocks."""
    return split_rows(full, table.block_rows, len(table.blocks))


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------
def param_shardings(model: nn.Module, mesh: Mesh,
                    shard_entity_table: bool = True,
                    shard_relations: bool = True) -> Dict[str, Optional[str]]:
    """Parameter name -> the mesh axis its rows split over (the model
    axis), or None for a replicated parameter: the reference's policy
    (``emb.ent`` by ``shard_entity_table``, each layer's ``coeff`` /
    ``w_rel`` by ``shard_relations``)."""
    model_ax = mesh_lib.model_axis(mesh)

    def spec(name: str) -> Optional[str]:
        if shard_entity_table and name == "emb.ent":
            return model_ax
        if shard_relations and name.rsplit(".", 1)[-1] in ("w_rel", "coeff"):
            return model_ax
        return None

    return {name: spec(name) for name, _ in model.named_parameters()}


def shard_params(model: nn.Module, mesh: Mesh, **kw) -> nn.Module:
    """Place ``model`` on ``mesh`` in place (:func:`param_shardings`'
    keywords): each row-sharded parameter becomes a
    :class:`RowShardedTable` over the model-axis devices, the rest moves
    to the mesh's first device.  Returns the model."""
    if is_sharded(model):
        raise ValueError("the model is already placed on a mesh")
    specs = param_shardings(model, mesh, **kw)
    model._logical_names = tuple(specs)  # the unsharded parameter order
    model.to(mesh.devices.flat[0])
    devices = mesh.axis_devices(mesh_lib.model_axis(mesh))
    for name, axis in specs.items():
        if axis is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        param = getattr(owner, leaf)
        attach_table(owner, leaf, RowShardedTable(
            param, devices, requires_grad=param.requires_grad))
    return model


def is_sharded(model: nn.Module) -> bool:
    return any(isinstance(m, RowShardedTable) for m in model.modules())


def _logical_entries(model: nn.Module):
    """``[(name, parameter or RowShardedTable)]`` in the unsharded
    parameter order."""
    return [(name, _lookup(model, name)) for name in model._logical_names]


def _lookup(model: nn.Module, name: str):
    owner_name, _, leaf = name.rpartition(".")
    return getattr(model.get_submodule(owner_name) if owner_name else model,
                   leaf)


def logical_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The model's parameters in the unsharded order, a row-sharded
    table's blocks in its place (the optimizer's order)."""
    if not is_sharded(model):
        return list(model.parameters())
    out = []
    for _, t in _logical_entries(model):
        out.extend(t.blocks if isinstance(t, RowShardedTable) else [t])
    return out


def optimizer_state_dict(model: nn.Module, optimizer) -> dict:
    """``optimizer.state_dict()`` in the unsharded layout: a row-sharded
    table's moments whole, pad rows dropped, one entry per unsharded
    parameter (the optimizer must take :func:`logical_parameters`)."""
    sd = optimizer.state_dict()
    if not is_sharded(model):
        return sd
    state, out, i = sd["state"], {}, 0
    for j, (_, t) in enumerate(_logical_entries(model)):
        if not isinstance(t, RowShardedTable):
            if i in state:
                out[j] = state[i]
            i += 1
            continue
        idx = range(i, i + len(t.blocks))
        i += len(t.blocks)
        if all(k in state for k in idx):
            dev = t.device
            out[j] = {key: torch.cat([state[k][key].to(dev) for k in idx]
                                     )[:t.n_rows]
                      for key in state[idx[0]]}
    groups = [dict(g, params=list(range(len(model._logical_names))))
              for g in sd["param_groups"]]
    return {"state": out, "param_groups": groups}


def load_optimizer_state_dict(model: nn.Module, optimizer, sd: dict) -> None:
    """Load an unsharded-layout optimizer state (from
    :func:`optimizer_state_dict` or an unsharded run) into the optimizer
    of ``model``, splitting a row-sharded table's moments like its
    blocks."""
    if not is_sharded(model):
        optimizer.load_state_dict(sd)
        return
    state, out, i = sd["state"], {}, 0
    for j, (_, t) in enumerate(_logical_entries(model)):
        if not isinstance(t, RowShardedTable):
            if j in state:
                out[i] = state[j]
            i += 1
            continue
        if j in state:
            parts = {key: _blocks_of(v, t) for key, v in state[j].items()}
            for b in range(len(t.blocks)):
                out[i + b] = {key: v[b] for key, v in parts.items()}
        i += len(t.blocks)
    groups = [dict(g, params=list(range(i))) for g in sd["param_groups"]]
    optimizer.load_state_dict({"state": out, "param_groups": groups})


# ----------------------------------------------------------------------
# Batches
# ----------------------------------------------------------------------
DENSE_BATCH_FIELDS = ("node_entity", "node_mode", "edge_rel", "edge_norm",
                      "target", "negatives", "neg_mask", "query_mask")
REPLICATED_FIELDS = ("edge_rel", "edge_norm")


def batch_shardings(mesh: Mesh) -> Dict[str, Optional[str]]:
    """Dense batch field -> the axis its leading (query) axis splits
    over, or None for the per-formula arrays replicated on every part."""
    data = mesh_lib.data_axis(mesh)
    return {k: None if k in REPLICATED_FIELDS else data
            for k in DENSE_BATCH_FIELDS}


def shard_dense_batch_arrays(mesh: Mesh, axis: int = 0,
                             **arrays) -> Dict[str, List[torch.Tensor]]:
    """Per-part lists of the batch arrays (numpy or tensors) on the
    data-axis devices: ``[B, ...]`` arrays split along ``axis`` (1 for
    ``[K, B, ...]`` stacks of K steps), the others copied to every part.
    ``ValueError`` when B does not split evenly."""
    sh = batch_shardings(mesh)
    devices = mesh.axis_devices(mesh_lib.data_axis(mesh))
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(np.ascontiguousarray(v)
                            if isinstance(v, np.ndarray) else v)
        if sh.get(k) is None:
            out[k] = [t.to(dev, non_blocking=True) for dev in devices]
            continue
        n = t.shape[axis]
        if n % len(devices):
            raise ValueError(f"{k}: {n} queries do not split into "
                             f"{len(devices)} data parts")
        out[k] = [b.to(dev, non_blocking=True)
                  for b, dev in zip(t.chunk(len(devices), dim=axis),
                                    devices)]
    return out
