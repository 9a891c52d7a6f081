"""Neighborhood aggregation encoder of the GQE baselines (counterpart of
``mpqe_tpu/models/aggregators.py``): an anchor entity's representation is
``combine(self, agg(sampled neighbors))``, GraphSAGE style.

Neighbor sampling happens once on the host into a fixed-fanout table
``[n_entities, fanout]`` (padded with the entity's own id and mask 0),
which the encoder reads by gather: no per-batch sampling, no ragged
shapes.  :func:`build_neighbor_table` gives the reference's table bit for
bit for the same ``(kg, fanout, seed)``, so a run's table can always be
rebuilt from its config.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from mpqe_tpu_torch.graph import KnowledgeGraph
from mpqe_tpu_torch.ops.rgcn import normal_

AGGREGATORS = ("mean", "max", "pool")


def build_neighbor_table(kg: KnowledgeGraph, fanout: int = 8,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """Uniformly sample up to ``fanout`` (undirected) neighbors per entity:
    ``{"idx": [n_entities, fanout] int32, "mask": ... float32}``; entities
    with fewer neighbors are padded with their own id and mask 0.  Each
    source row's edges are shuffled by a random key per edge (a stable
    lexsort by (src, key)) and the first ``fanout`` kept: sampling without
    replacement, the reference's RNG stream."""
    rng = np.random.default_rng(seed)
    src, _, dst = kg.directed_edges()
    keys = rng.random(src.shape[0])
    order = np.lexsort((keys, src))
    src_s, dst_s = src[order], dst[order]
    ptr = np.searchsorted(src_s, np.arange(kg.n_entities + 1))
    pos = np.arange(src_s.shape[0], dtype=np.int64) - ptr[src_s]
    sel = pos < fanout
    idx = np.tile(np.arange(kg.n_entities, dtype=np.int32)[:, None],
                  (1, fanout))
    mask = np.zeros((kg.n_entities, fanout), np.float32)
    idx[src_s[sel], pos[sel]] = dst_s[sel]
    mask[src_s[sel], pos[sel]] = 1.0
    return {"idx": idx, "mask": mask}


def build_neighbor_table_device(kg: KnowledgeGraph, fanout: int = 8,
                                seed: int = 0,
                                device=None) -> Dict[str, torch.Tensor]:
    """:func:`build_neighbor_table` as tensors on ``device``: the one entry
    point of training, evaluation and serving, so the table a checkpoint
    was trained with is the table its evaluation rebuilds."""
    nt = build_neighbor_table(kg, fanout=fanout, seed=seed)
    return {k: torch.from_numpy(v).to(device) for k, v in nt.items()}


class NeighborhoodEncoder(nn.Module):
    """The encoder's parameters: ``w_combine [2d, d]``, ``b_combine [d]``
    and, for ``pool``, ``w_pool [d, d]``, ``b_pool [d]``."""

    def __init__(self, d: int, aggregator: str = "mean", device=None):
        super().__init__()
        if aggregator not in AGGREGATORS:
            raise ValueError(f"aggregator {aggregator}")

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.w_combine = p(2 * d, d)
        self.b_combine = p(d)
        if aggregator == "pool":
            self.w_pool = p(d, d)
            self.b_pool = p(d)


def init_neighborhood_encoder(gen: torch.Generator, d: int,
                              aggregator: str = "mean",
                              device=None) -> NeighborhoodEncoder:
    """Weights ``N(0, 1/d)`` (the reference's ``sqrt(2 / 2d)``), biases 0."""
    enc = NeighborhoodEncoder(d, aggregator, device=device)
    scale = math.sqrt(2.0 / (2 * d))
    with torch.no_grad():
        enc.w_combine.copy_(normal_(gen, (2 * d, d), scale, device))
        enc.b_combine.zero_()
        if aggregator == "pool":
            enc.w_pool.copy_(normal_(gen, (d, d), scale, device))
            enc.b_pool.zero_()
    return enc


def _masked_max(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Max over the fanout axis of the unmasked rows; 0 where every row is
    masked (the reference's ``-inf`` -> 0)."""
    agg = torch.amax(torch.where(m > 0, x, float("-inf")), dim=1)
    return torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))


def encode_entities(enc: NeighborhoodEncoder, ent_table: torch.Tensor,
                    neighbor_idx: torch.Tensor, neighbor_mask: torch.Tensor,
                    entity_ids: torch.Tensor,
                    aggregator: str = "mean") -> torch.Tensor:
    """GraphSAGE-style entity encoding ``relu([self; agg] @ w_combine +
    b_combine)`` of ``entity_ids`` (any shape; ids clamped, as the
    reference's gathers clamp them) → ``entity_ids.shape + (d,)``.
    ``neighbor_idx``/``neighbor_mask`` are the full tables (rows by
    entity id)."""
    n = ent_table.shape[0]
    flat = entity_ids.reshape(-1).long().clamp(0, n - 1)
    self_emb = ent_table[flat]  # [N, d]
    nb = ent_table[neighbor_idx[flat].long().clamp(0, n - 1)]  # [N, F, d]
    m = neighbor_mask[flat][:, :, None]  # [N, F, 1]
    if aggregator == "mean":
        agg = torch.sum(nb * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                     min=1.0)
    elif aggregator == "max":
        agg = _masked_max(nb, m)
    else:  # pool: per-neighbor MLP, then max
        h = torch.relu(torch.einsum("nfd,do->nfo", nb, enc.w_pool)
                       + enc.b_pool)
        agg = _masked_max(h, m)
    out = torch.relu(torch.cat([self_emb, agg], dim=-1) @ enc.w_combine
                     + enc.b_combine)
    return out.reshape(tuple(entity_ids.shape) + (out.shape[-1],))
