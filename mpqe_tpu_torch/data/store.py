"""FormulaStore: flattened, array-native storage of a formula's queries
(counterpart of ``mpqe_tpu/data/store.py``).

Each (formula -> query list) collapses once into flat numpy arrays —
anchors ``[n_q, n_anchors]``, targets ``[n_q]``, CSR negative pools —
which :func:`pack_dense_batch_np` turns into dense batches with no
Python-object work per step.  Numpy only: the same seed gives the same
arrays as the reference, exactly.  :func:`stores_from_edges` builds the
raw-edge 1-chain stores straight from a KG's arrays.  The C++ packer
(``data/native.py pack_dense_batch_native``) packs the same fields from
another random stream; the training loop takes it when it builds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from mpqe_tpu_torch.data.batcher import DenseQueryBatch, template_edge_norm
from mpqe_tpu_torch.queries import Formula, Query

# fallback-negative probe bound: a draw that hits a true answer walks
# forward through the pool at most this many entries before giving up
# (leaving the slot masked)
FB_PROBE_CAP = 64


@dataclasses.dataclass(frozen=True)
class FormulaStore:
    """All queries of one formula, flattened."""

    formula: Formula
    anchors: np.ndarray  # [n_q, n_anchors] int32
    targets: np.ndarray  # [n_q] int32
    neg_pool: np.ndarray  # [sum |negs|] int32
    neg_ptr: np.ndarray  # [n_q + 1] int64
    hard_pool: np.ndarray  # [sum |hard|] int32
    hard_ptr: np.ndarray  # [n_q + 1] int64
    # entities of the target's mode, sampled at pack time for queries
    # whose negative range is empty
    fallback_pool: Optional[np.ndarray] = None
    # optional true-answer exclusion for the fallback: per answer group a
    # sorted id slice ans_pool[ans_ptr[g]:ans_ptr[g + 1]], per query its
    # group ans_idx[qi]
    ans_pool: Optional[np.ndarray] = None
    ans_ptr: Optional[np.ndarray] = None
    ans_idx: Optional[np.ndarray] = None

    @property
    def n_queries(self) -> int:
        return int(self.targets.shape[0])


def build_formula_store(
    formula: Formula,
    queries: Sequence[Query],
    fallback_pool: Optional[np.ndarray] = None,
) -> FormulaStore:
    """Flatten queries; ``fallback_pool`` (entity ids of the target's
    mode) is kept once for queries without pre-sampled negatives."""
    n_q = len(queries)
    n_a = formula.spec.n_anchors
    anchors = np.zeros((n_q, n_a), np.int32)
    targets = np.zeros((n_q,), np.int32)
    neg_ptr = np.zeros((n_q + 1,), np.int64)
    hard_ptr = np.zeros((n_q + 1,), np.int64)
    for i, q in enumerate(queries):
        anchors[i] = q.anchors
        targets[i] = q.target
        neg_ptr[i + 1] = neg_ptr[i] + len(q.neg_samples)
        hard_ptr[i + 1] = hard_ptr[i] + len(q.hard_neg_samples)
    neg_pool = np.zeros((int(neg_ptr[-1]),), np.int32)
    hard_pool = np.zeros((int(hard_ptr[-1]),), np.int32)
    for i, q in enumerate(queries):
        neg_pool[neg_ptr[i]:neg_ptr[i + 1]] = q.neg_samples
        hard_pool[hard_ptr[i]:hard_ptr[i + 1]] = q.hard_neg_samples
    if fallback_pool is not None:
        fallback_pool = np.ascontiguousarray(fallback_pool, np.int32)
        if not fallback_pool.size:
            fallback_pool = None
    return FormulaStore(
        formula=formula, anchors=anchors, targets=targets,
        neg_pool=neg_pool, neg_ptr=neg_ptr,
        hard_pool=hard_pool, hard_ptr=hard_ptr,
        fallback_pool=fallback_pool,
    )


def build_stores(
    grouped: Dict[str, Dict[Formula, List[Query]]],
    kg=None,
) -> Dict[str, List[FormulaStore]]:
    """Flatten grouped queries; with the KnowledgeGraph, queries without
    pre-sampled negatives draw same-mode fallback negatives."""
    out: Dict[str, List[FormulaStore]] = {}
    for s, by_f in grouped.items():
        stores = []
        for f, qs in by_f.items():
            fb = kg.entities_of_mode(f.target_mode) if kg is not None else None
            stores.append(build_formula_store(f, qs, fallback_pool=fb))
        out[s] = stores
    return out


def stores_from_edges(
    kg, exclude_answers: bool = True
) -> Dict[str, List[FormulaStore]]:
    """Raw-edge 1-chain training stores straight from the KG's triple
    arrays — zero per-edge Python objects (the 100M-edge scale path for
    the reference's ``train_edges.pkl`` protocol, SURVEY.md §A.3).

    One store per directed relation (anchors = sources, targets =
    destinations); negatives come from the shared same-mode fallback
    pool at pack time, EXCLUDING the full (head, rel) answer set — the
    reference's train_edges protocol (SURVEY.md §A.4).  The exclusion
    structure is the relation block itself regrouped by head (storage
    O(edges)).  ``exclude_answers=False`` skips building it (one lexsort
    per relation block — worth skipping only at extreme scale, where the
    false-negative rate ~ answer-set-size / mode-size is negligible
    anyway).  Pass the result as ``run_train``'s ``train_stores``."""
    src, rel, dst = kg.directed_edges()
    order = np.argsort(rel, kind="stable")
    src = np.ascontiguousarray(src[order], np.int32)
    rel = np.ascontiguousarray(rel[order], np.int32)
    dst = np.ascontiguousarray(dst[order], np.int32)
    bounds = np.searchsorted(rel, np.arange(kg.n_rels + 1))
    stores: List[FormulaStore] = []
    mode_pools: Dict[int, np.ndarray] = {}  # shared across stores
    for r in range(kg.n_rels):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        if hi == lo:
            continue
        dm, rm = kg.rel_id_modes(r)
        if int(rm) not in mode_pools:
            mode_pools[int(rm)] = np.ascontiguousarray(
                kg.entities_of_mode(int(rm)), np.int32)
        n = hi - lo
        # answer groups: one per unique head; each edge (query) points
        # at its head's group, whose slice is that head's full tail set
        s_blk, d_blk = src[lo:hi], dst[lo:hi]
        ans_pool = ans_ptr = ans_idx = None
        if exclude_answers:
            grp_order = np.lexsort((d_blk, s_blk))
            s_sorted = s_blk[grp_order]
            ans_pool = np.ascontiguousarray(d_blk[grp_order])
            heads, inv = np.unique(s_sorted, return_inverse=True)
            ans_ptr = np.zeros(len(heads) + 1, np.int64)
            np.add.at(ans_ptr, inv + 1, 1)
            np.cumsum(ans_ptr, out=ans_ptr)
            # ans_idx aligned to QUERY order (the unsorted block)
            ans_idx = np.searchsorted(heads, s_blk).astype(np.int32)
        stores.append(FormulaStore(
            formula=Formula("1-chain", (int(r),), (int(dm), int(rm))),
            anchors=np.ascontiguousarray(s_blk[:, None]),
            targets=d_blk,
            neg_pool=np.zeros(0, np.int32),
            neg_ptr=np.zeros(n + 1, np.int64),
            hard_pool=np.zeros(0, np.int32),
            hard_ptr=np.zeros(n + 1, np.int64),
            fallback_pool=mode_pools[int(rm)],
            ans_pool=ans_pool, ans_ptr=ans_ptr, ans_idx=ans_idx,
        ))
    return {"1-chain": stores}


def pack_dense_batch_np(
    store: FormulaStore,
    pick: np.ndarray,  # [n_pick] query indices
    batch_size: int,
    n_neg: int,
    seed: int,
    use_hard: bool = False,
) -> DenseQueryBatch:
    """Pack the picked queries into a ``batch_size`` batch (padding
    repeats query 0, masked out), drawing ``n_neg`` negatives per query
    from its pool with ``np.random.default_rng(seed)``: the reference's
    numpy packer, draw for draw."""
    spec = store.formula.spec
    rng = np.random.default_rng(seed)
    n_pick = len(pick)
    B = batch_size
    node_entity = np.zeros((B, spec.n_nodes), np.int32)
    node_mode = np.broadcast_to(
        np.asarray(store.formula.node_modes, np.int32)[None, :],
        (B, spec.n_nodes)).copy()
    target = np.zeros((B,), np.int32)
    negatives = np.zeros((B, n_neg), np.int32)
    neg_mask = np.zeros((B, n_neg), np.float32)
    query_mask = np.zeros((B,), np.float32)

    pool, ptr = ((store.hard_pool, store.hard_ptr) if use_hard
                 else (store.neg_pool, store.neg_ptr))
    fb = store.fallback_pool
    fb_size = 0 if fb is None else int(fb.size)
    for b, qi in enumerate(pick):
        for a_i, slot in enumerate(spec.anchor_slots):
            node_entity[b, slot] = store.anchors[qi, a_i]
        target[b] = store.targets[qi]
        lo, hi = int(ptr[qi]), int(ptr[qi + 1])
        if hi == lo and use_hard:  # fall back to regular negatives
            lo, hi = int(store.neg_ptr[qi]), int(store.neg_ptr[qi + 1])
            pool_b = store.neg_pool
        else:
            pool_b = pool
        if hi > lo:
            negatives[b] = pool_b[lo + rng.integers(0, hi - lo, n_neg)]
            neg_mask[b] = 1.0
        elif fb_size:
            ans = None
            if store.ans_idx is not None:
                g = int(store.ans_idx[qi])
                ans = store.ans_pool[
                    int(store.ans_ptr[g]):int(store.ans_ptr[g + 1])]
            idx = rng.integers(0, fb_size, n_neg)
            draw = fb[idx]
            bad = draw == target[b]
            if ans is not None and ans.size:
                j = np.searchsorted(ans, draw)
                j_c = np.minimum(j, ans.size - 1)
                bad |= (j < ans.size) & (ans[j_c] == draw)
            ok = ~bad
            negatives[b, ok] = draw[ok]
            neg_mask[b, ok] = 1.0
            cap = min(fb_size, FB_PROBE_CAP)
            for k in np.nonzero(bad)[0]:
                for p in range(1, cap):
                    c = int(fb[(int(idx[k]) + p) % fb_size])
                    if c == target[b]:
                        continue
                    if ans is not None:
                        j = int(np.searchsorted(ans, c))
                        if j < ans.size and int(ans[j]) == c:
                            continue
                    negatives[b, k] = c
                    neg_mask[b, k] = 1.0
                    break
        query_mask[b] = 1.0
    if n_pick < B:
        node_entity[n_pick:] = node_entity[0]
        target[n_pick:] = target[0]
        negatives[n_pick:] = negatives[0]
    return DenseQueryBatch(
        structure=store.formula.structure,
        n_queries=n_pick,
        node_entity=node_entity,
        node_mode=node_mode,
        edge_rel=np.asarray(store.formula.rels, np.int32),
        edge_norm=template_edge_norm(spec, store.formula.rels),
        target=target,
        negatives=negatives,
        neg_mask=neg_mask,
        query_mask=query_mask,
        used_hard=use_hard,
    )
