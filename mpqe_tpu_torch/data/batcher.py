"""Query batching (counterpart of ``mpqe_tpu/data/batcher.py``): the
bucket and edge-normalizer helpers serving shares, the dense batch that
training packs (``data/store.py``) and the per-formula evaluation makes
(:func:`make_dense_batch`), and its flattened sparse view
(:class:`SparseQueryBatch`, :func:`dense_to_sparse`), which feeds
``encode_sparse``.  Host-side numpy, the same arrays as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from mpqe_tpu_torch.ops.edge_store import EdgeStore, build_edge_store
from mpqe_tpu_torch.queries import STRUCTURES, Formula, Query, QueryStructure


def bucket_size(n: int, min_bucket: int = 16) -> int:
    """Round a batch size up to the next power-of-two bucket."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


def template_edge_norm(spec: QueryStructure, rels: Sequence[int]) -> np.ndarray:
    """1 / |N_r(dst)| per template edge (mean-per-relation; SURVEY.md §A.1)."""
    counts: Dict[Tuple[int, int], int] = {}
    for j in range(spec.n_edges):
        k = (spec.edge_dst[j], int(rels[j]))
        counts[k] = counts.get(k, 0) + 1
    return np.array(
        [1.0 / counts[(spec.edge_dst[j], int(rels[j]))] for j in range(spec.n_edges)],
        dtype=np.float32,
    )


@dataclasses.dataclass(frozen=True)
class DenseQueryBatch:
    """B same-formula queries as dense template-slot arrays (numpy; the
    train step moves them to the device).

      structure: structure name; n_queries: true (unpadded) query count.
      node_entity: ``[B, n_nodes] int32`` entity id per anchor slot (0 on
        variable/target slots).
      node_mode: ``[B, n_nodes] int32`` entity-mode id per slot.
      edge_rel: ``[n_edges] int32`` formula relations (template order).
      edge_norm: ``[n_edges] float32`` 1/c_{dst,rel} within the template.
      target: ``[B] int32`` true answers; negatives ``[B, K] int32``;
      neg_mask ``[B, K] float32`` (1 on real negatives); query_mask
        ``[B] float32`` (1 on real queries).
      used_hard: the negatives came from the hard (strict-subset) pools.
    """

    structure: str
    n_queries: int
    node_entity: np.ndarray
    node_mode: np.ndarray
    edge_rel: np.ndarray
    edge_norm: np.ndarray
    target: np.ndarray
    negatives: np.ndarray
    neg_mask: np.ndarray
    query_mask: np.ndarray
    used_hard: bool = False

    @property
    def spec(self) -> QueryStructure:
        return STRUCTURES[self.structure]

    @property
    def batch_size(self) -> int:
        return int(self.node_entity.shape[0])


@dataclasses.dataclass(frozen=True)
class SparseQueryBatch:
    """The same batch flattened into one relation-typed graph: node
    ``b * n_nodes + slot``; ``node_query`` maps a node to its query (the
    sum/max readouts' segments), ``target_node`` gives each query's target
    node; ``edges`` is relation-sorted."""

    structure: str
    n_queries: int
    node_entity: np.ndarray  # [N] int32
    node_mode: np.ndarray  # [N] int32
    node_is_var: np.ndarray  # [N] float32 (1 on variable/target slots)
    node_query: np.ndarray  # [N] int32
    target_node: np.ndarray  # [B] int32
    edges: EdgeStore
    target: np.ndarray
    negatives: np.ndarray
    neg_mask: np.ndarray
    query_mask: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.node_entity.shape[0])


def make_dense_batch(
    formula: Formula,
    queries: Sequence[Query],
    batch_size: Optional[int] = None,
    n_neg: int = 1,
    rng: Optional[np.random.Generator] = None,
    use_hard_negatives: bool = False,
) -> DenseQueryBatch:
    """Pack same-formula queries into a padded dense batch.  Negatives are
    drawn (with replacement when the pool is smaller than ``n_neg``) from
    each query's ``neg_samples`` (``hard_neg_samples`` when asked for and
    present) by ``rng``, ``np.random.default_rng(0)`` by default, in the
    reference's order, so the same queries get the same negatives.  Padded
    rows repeat query 0's entities, target and negatives."""
    spec = formula.spec
    n_q = len(queries)
    if n_q == 0:
        raise ValueError("empty query batch")
    B = batch_size if batch_size is not None else bucket_size(n_q)
    if B < n_q:
        raise ValueError(f"batch_size {B} < n_queries {n_q}")
    rng = rng or np.random.default_rng(0)

    node_entity = np.zeros((B, spec.n_nodes), dtype=np.int32)
    node_mode = np.zeros((B, spec.n_nodes), dtype=np.int32)
    node_mode[:] = np.asarray(formula.node_modes, dtype=np.int32)[None, :]
    target = np.zeros((B,), dtype=np.int32)
    negatives = np.zeros((B, n_neg), dtype=np.int32)
    neg_mask = np.zeros((B, n_neg), dtype=np.float32)
    query_mask = np.zeros((B,), dtype=np.float32)
    for b, q in enumerate(queries):
        for a_i, slot in enumerate(spec.anchor_slots):
            node_entity[b, slot] = q.anchors[a_i]
        target[b] = q.target
        pool = (q.hard_neg_samples
                if (use_hard_negatives and q.hard_neg_samples)
                else q.neg_samples)
        if pool:
            pool_arr = np.asarray(pool, dtype=np.int32)
            negatives[b] = rng.choice(pool_arr, size=n_neg,
                                      replace=len(pool_arr) < n_neg)
            neg_mask[b] = 1.0
        query_mask[b] = 1.0
    if n_q < B:
        node_entity[n_q:] = node_entity[0]
        target[n_q:] = target[0]
        negatives[n_q:] = negatives[0]
    return DenseQueryBatch(
        structure=formula.structure, n_queries=n_q, node_entity=node_entity,
        node_mode=node_mode, edge_rel=np.asarray(formula.rels, dtype=np.int32),
        edge_norm=template_edge_norm(spec, formula.rels), target=target,
        negatives=negatives, neg_mask=neg_mask, query_mask=query_mask,
        used_hard=use_hard_negatives)


def dense_to_sparse(batch: DenseQueryBatch, n_rels: int,
                    edge_capacity: Optional[int] = None) -> SparseQueryBatch:
    """Flatten a dense batch into one relation-sorted batched graph
    (``ops/edge_store.py:build_edge_store``, padded to ``edge_capacity``)."""
    spec = batch.spec
    B, n = batch.batch_size, spec.n_nodes
    N = B * n
    is_var = np.zeros((n,), dtype=np.float32)
    is_var[list(spec.free_slots)] = 1.0
    offs = np.arange(B, dtype=np.int32)[:, None] * n
    src = (offs + np.asarray(spec.edge_src, np.int32)[None, :]).reshape(-1)
    dst = (offs + np.asarray(spec.edge_dst, np.int32)[None, :]).reshape(-1)
    edges = build_edge_store(src, dst, np.tile(batch.edge_rel, B),
                             n_nodes=N, n_rels=n_rels,
                             capacity=edge_capacity,
                             norm=np.tile(batch.edge_norm, B))
    return SparseQueryBatch(
        structure=batch.structure, n_queries=batch.n_queries,
        node_entity=batch.node_entity.reshape(N).copy(),
        node_mode=batch.node_mode.reshape(N).copy(),
        node_is_var=np.tile(is_var, B),
        node_query=np.repeat(np.arange(B, dtype=np.int32), n),
        target_node=(np.arange(B, dtype=np.int32) * n
                     + np.int32(spec.target_slot)),
        edges=edges, target=batch.target, negatives=batch.negatives,
        neg_mask=batch.neg_mask, query_mask=batch.query_mask)
