"""Entity and variable embedding tables (counterpart of
``mpqe_tpu/models/embeddings.py``): ``ent [n_entities, d]`` in a global
id space and ``var [n_modes, d]``, one learned row per entity mode.

``ent`` is a parameter, or on a mesh a row-sharded table
(``parallel/sharding.py RowShardedTable``).  The entity rows that the
encoders, losses and sweeps read go through one accessor,
:func:`entity_rows`, and the kernel operand of a table through
:func:`table_operand`, so either kind of table serves them."""

from __future__ import annotations

import math

import torch
from torch import nn

from mpqe_tpu_torch.ops.rgcn import normal_


class Embeddings(nn.Module):
    def __init__(self, n_entities: int, n_modes: int, d: int, device=None):
        super().__init__()
        self.ent = nn.Parameter(torch.empty(n_entities, d, device=device))
        self.var = nn.Parameter(torch.empty(n_modes, d, device=device))


def init_embeddings(gen: torch.Generator, n_entities: int, n_modes: int,
                    d: int, device=None) -> Embeddings:
    """``N(0, 1/d)`` rows for both tables (the reference's scaled-down
    normal keeps cosine scores in a sane range)."""
    emb = Embeddings(n_entities, n_modes, d, device=device)
    scale = 1.0 / math.sqrt(d)
    with torch.no_grad():
        emb.ent.copy_(normal_(gen, (n_entities, d), scale, device))
        emb.var.copy_(normal_(gen, (n_modes, d), scale, device))
    return emb


def entity_rows(ent, ids: torch.Tensor) -> torch.Tensor:
    """``ent[ids]`` on ``ids``' device.  A parameter clamps the ids into
    range, as the reference's gather does; a row-sharded table takes
    each row from its owner block (``RowShardedTable.rows``)."""
    if isinstance(ent, torch.Tensor):
        return ent[ids.long().clamp(0, ent.shape[0] - 1)]
    return ent.rows(ids)


def table_operand(ent):
    """The table as a kernel's operand: a parameter detached (no copy
    when it is contiguous), a row-sharded table as it is (the kernel's
    wrapper gathers the rows it reads, ``RowShardedTable.compact``)."""
    if isinstance(ent, torch.Tensor):
        return ent.detach().contiguous()
    return ent


def embed_nodes_dense(emb: Embeddings, node_entity: torch.Tensor,
                      node_mode: torch.Tensor,
                      is_var_slot: torch.Tensor) -> torch.Tensor:
    """Initial node features ``[B, n, d]`` of a dense template batch:
    anchor slots get their entity row, variable/target slots the per-mode
    variable row (``is_var_slot [n]``, 1 on variable slots)."""
    x_ent = entity_rows(emb.ent, node_entity)
    x_var = emb.var[node_mode.long()]
    m = is_var_slot.to(x_ent.dtype)[None, :, None]
    return x_var * m + x_ent * (1.0 - m)


def embed_nodes_sparse(emb: Embeddings, node_entity: torch.Tensor,
                       node_mode: torch.Tensor,
                       node_is_var: torch.Tensor) -> torch.Tensor:
    """Initial features ``[N, d]`` of a flat (sparse) node list: the entity
    row, or the per-mode variable row where ``node_is_var`` is 1 (ids
    clamped, as the reference's gathers do)."""
    x_ent = entity_rows(emb.ent, node_entity)
    x_var = emb.var[node_mode.long().clamp(0, emb.var.shape[0] - 1)]
    m = node_is_var.to(x_ent.dtype)[:, None]
    return x_var * m + x_ent * (1.0 - m)


def embed_nodes_template(emb: Embeddings, node_entity: torch.Tensor,
                         node_mode: torch.Tensor, anchor_slots, n_nodes: int,
                         anchor_rows=None) -> torch.Tensor:
    """Slot-static :func:`embed_nodes_dense` → ``[B, n, d]``: only anchor
    slots read the entity table (ids clamped, as the reference's gather
    does), the others the per-mode table (an out-of-range mode selects a
    zero row, as the reference's one-hot does).  ``anchor_rows``
    ``[B, n_anchors, d]`` (one column per anchor slot, in slot order)
    replaces the entity gather."""
    from mpqe_tpu_torch.ops.fused_fwd import _rows_by_mode

    anchors = set(anchor_slots)
    a_col = {s: k for k, s in enumerate(sorted(anchors))}
    cols = []
    for s in range(n_nodes):
        if s in anchors:
            if anchor_rows is not None:
                cols.append(anchor_rows[:, a_col[s], :])
            else:
                cols.append(entity_rows(emb.ent, node_entity[:, s]))
        else:
            cols.append(_rows_by_mode(emb.var, node_mode[:, s]).to(
                emb.var.dtype))
    return torch.stack(cols, dim=1)
