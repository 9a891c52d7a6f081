"""Relation-typed edge store: padded, relation-sorted COO for the sparse
kernels (a numpy copy of ``mpqe_tpu/ops/edge_store.py``).

Edges are sorted by ``(rel, dst)``, padded to a fixed capacity with the
sentinel relation ``n_rels``, ``src = dst = n_nodes`` and ``norm = 0``;
``rel_ptr`` holds the CSR offsets of the relation blocks.  Host-side
numpy: the general-graph layouts (``ops/rgcn_fused.py:chunk_by_relation``,
``ops/rgcn_blocked.py:bucket_edges_blocked``) are built from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class EdgeStore:
    """A padded, relation-sorted batch of typed directed edges.

    ``src``, ``dst``: ``[capacity] int32`` (padding: ``n_nodes``);
    ``rel``: ``[capacity] int32`` (padding: ``n_rels``); ``norm``:
    ``[capacity] float32`` ``1 / c_{dst, rel}`` (0 on padding);
    ``rel_ptr``: ``[n_rels + 2] int32``; ``n_edges``, ``n_nodes``,
    ``n_rels``: Python ints."""

    src: np.ndarray
    dst: np.ndarray
    rel: np.ndarray
    norm: np.ndarray
    rel_ptr: np.ndarray
    n_edges: int
    n_nodes: int
    n_rels: int

    @property
    def capacity(self) -> int:
        return int(self.src.shape[0])

    @property
    def pad_mask(self) -> np.ndarray:
        """``[capacity] bool`` — True on real edges."""
        return self.rel < self.n_rels


def compute_edge_norm(dst: np.ndarray, rel: np.ndarray, n_nodes: int,
                      n_rels: int) -> np.ndarray:
    """Per-edge ``1 / |N_rel(dst)|`` (mean aggregation per relation)."""
    key = dst.astype(np.int64) * (n_rels + 1) + rel.astype(np.int64)
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    return (1.0 / counts[inv]).astype(np.float32)


def build_edge_store(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                     n_nodes: int, n_rels: int,
                     capacity: Optional[int] = None,
                     norm: Optional[np.ndarray] = None) -> EdgeStore:
    """Sort edges by (rel, dst), pad to ``capacity``, build ``rel_ptr``.
    ``norm`` defaults to the mean-per-relation normalizer; an explicit
    array is aligned with the input edge order."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    rel = np.asarray(rel, dtype=np.int32)
    n_e = int(src.shape[0])
    if capacity is None:
        capacity = n_e
    if capacity < n_e:
        raise ValueError(f"capacity {capacity} < n_edges {n_e}")
    if n_e and rel.max() >= n_rels:
        raise ValueError("relation id out of range")
    if norm is None:
        norm = compute_edge_norm(dst, rel, n_nodes, n_rels)
    else:
        norm = np.asarray(norm, dtype=np.float32)

    order = np.lexsort((dst, rel))
    src_s = np.full(capacity, n_nodes, dtype=np.int32)
    dst_s = np.full(capacity, n_nodes, dtype=np.int32)
    rel_s = np.full(capacity, n_rels, dtype=np.int32)
    norm_s = np.zeros(capacity, dtype=np.float32)
    src_s[:n_e] = src[order]
    dst_s[:n_e] = dst[order]
    rel_s[:n_e] = rel[order]
    norm_s[:n_e] = norm[order]

    counts = np.bincount(rel_s[:n_e], minlength=n_rels)
    rel_ptr = np.zeros(n_rels + 2, dtype=np.int32)
    np.cumsum(counts, out=rel_ptr[1:n_rels + 1])
    rel_ptr[n_rels + 1] = capacity  # padding block
    return EdgeStore(src=src_s, dst=dst_s, rel=rel_s, norm=norm_s,
                     rel_ptr=rel_ptr, n_edges=n_e, n_nodes=int(n_nodes),
                     n_rels=int(n_rels))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def coo_roundtrip_check(store: EdgeStore) -> bool:
    """Invariants: sorted by (rel, dst); rel_ptr consistent with rel."""
    m = store.pad_mask
    rel, dst = store.rel[m], store.dst[m]
    if rel.size == 0:
        return True
    key = rel.astype(np.int64) * (store.n_nodes + 1) + dst.astype(np.int64)
    if np.any(np.diff(key) < 0):
        return False
    for r in range(store.n_rels):
        lo, hi = store.rel_ptr[r], store.rel_ptr[r + 1]
        if not np.all(store.rel[lo:hi] == r):
            return False
    return True
