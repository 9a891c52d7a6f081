"""Query batching (counterpart of ``mpqe_tpu/data/batcher.py``): the
bucket and edge-normalizer helpers serving shares, and the dense batch
that training packs (``data/store.py``).  The sparse batch comes with the
sparse slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from mpqe_tpu_torch.queries import QueryStructure


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
