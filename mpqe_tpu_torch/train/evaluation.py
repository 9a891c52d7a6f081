"""Evaluation: per-structure ROC-AUC and APR (average percentile rank)
(counterpart of ``mpqe_tpu/train/evaluation.py``).

* AUC per formula: scores of true answers vs each query's stored
  negative samples, macro-averaged per query structure; hard-negative
  AUC separately for intersection structures.
* APR: per query, the percentile rank of the true answer's score among
  its negative candidates, averaged.

ROC-AUC is exact (Mann-Whitney U with tie correction).  Three sweeps:

* :func:`evaluate_batched` encodes all formulas of a structure at once
  through the per-query-relation encoder, K3
  (``encode_dense_multi_auto``) for eligible MPQE models, the GQE
  baselines through ``gqe.score_pos_neg`` (SoftAnd by conjunct-min);
* :func:`evaluate` is the reference's per-formula protocol for MPQE
  models: one padded dense batch per formula through a caller's
  ``encode_fn`` (by default the f32 ``encode_dense``; the sparse encoder
  through an adapter, as ``run_train(eval_encode_fn=...)`` passes it);
* :func:`full_ranking` ranks the true answer among every entity of its
  mode (MRR, Hits@K), one ``[B, n_entities]`` score matrix per chunk on
  the device; :func:`full_ranking_sharded` does the same over an entity
  table row-sharded on a mesh's model axis, with no ``[B, n_entities]``
  matrix on any device (``parallel/rank_shard.py``).

Every sweep runs under ``torch.no_grad()`` on the model's device.  The
GQE sweeps take ``neighbor_table=`` for a neighborhood anchor encoder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpqe_tpu_torch.data.batcher import (bucket_size, make_dense_batch,
                                         template_edge_norm)
from mpqe_tpu_torch.models import is_mpqe
from mpqe_tpu_torch.queries import (INTERSECTION_STRUCTURES, STRUCTURES,
                                    Formula, Query)


def _effective_max_batch(cfg, max_batch: int, per_row_elems: int) -> int:
    """Cap the sweep chunk so per-dispatch intermediates stay bounded.

    ``per_row_elems`` = device elements materialized per batch row (e.g.
    ``n_entities`` for a full score matrix, ``d*do`` per gathered
    full-weight relation matrix).  Budget: ~2^28 fp32 elements (1 GiB)
    per intermediate."""
    cap = max(256, (1 << 28) // max(per_row_elems, 1))
    return min(max_batch, cap)


def roc_auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """Exact ROC-AUC of pos-vs-neg score samples (Mann-Whitney U / ranks,
    average ties)."""
    pos = np.asarray(pos, dtype=np.float64).ravel()
    neg = np.asarray(neg, dtype=np.float64).ravel()
    if pos.size == 0 or neg.size == 0:
        return float("nan")
    scores = np.concatenate([pos, neg])
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, scores.size + 1, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < sorted_scores.size:
        j = i
        while (j + 1 < sorted_scores.size
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    u = ranks[:pos.size].sum() - pos.size * (pos.size + 1) / 2.0
    return float(u / (pos.size * neg.size))


@dataclasses.dataclass
class EvalResult:
    auc_by_structure: Dict[str, float]
    apr_by_structure: Dict[str, float]
    hard_auc_by_structure: Dict[str, float]

    @property
    def macro_auc(self) -> float:
        vals = [v for v in self.auc_by_structure.values() if np.isfinite(v)]
        return float(np.mean(vals)) if vals else float("nan")

    @property
    def macro_apr(self) -> float:
        vals = [v for v in self.apr_by_structure.values() if np.isfinite(v)]
        return float(np.mean(vals)) if vals else float("nan")

    def flat(self) -> Dict[str, float]:
        out = {"auc_macro": self.macro_auc, "apr_macro": self.macro_apr}
        for k, v in self.auc_by_structure.items():
            out[f"auc/{k}"] = v
        for k, v in self.apr_by_structure.items():
            out[f"apr/{k}"] = v
        for k, v in self.hard_auc_by_structure.items():
            out[f"auc_hard/{k}"] = v
        return out


@dataclasses.dataclass
class EvalSet:
    """Eval queries flattened per structure across all its formulas
    (per-query relation ids make them encodable in one call); built
    once, reused every validation round."""

    by_structure: Dict[str, Dict[str, np.ndarray]]


def make_eval_set(
    queries_by_structure: Dict[str, Dict[Formula, List[Query]]],
    max_queries_per_formula: Optional[int] = 1000,
    require_negatives: bool = True,
) -> EvalSet:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for structure, by_formula in queries_by_structure.items():
        spec = STRUCTURES[structure]
        ne_l, nm_l, er_l, en_l = [], [], [], []
        tgt_l, fid_l = [], []
        neg_lists, hard_lists = [], []
        n_formulas = 0
        for formula, qs in by_formula.items():
            if max_queries_per_formula:
                qs = qs[:max_queries_per_formula]
            if require_negatives:
                qs = [q for q in qs if q.neg_samples]
            if not qs:
                continue
            fid = n_formulas
            n_formulas += 1
            en = template_edge_norm(spec, formula.rels)
            for q in qs:
                ne = np.zeros((spec.n_nodes,), np.int32)
                for a_i, s in enumerate(spec.anchor_slots):
                    ne[s] = q.anchors[a_i]
                ne_l.append(ne)
                nm_l.append(np.asarray(formula.node_modes, np.int32))
                er_l.append(np.asarray(formula.rels, np.int32))
                en_l.append(en)
                tgt_l.append(q.target)
                fid_l.append(fid)
                neg_lists.append(np.asarray(q.neg_samples, np.int32))
                hard_lists.append(np.asarray(q.hard_neg_samples, np.int32))
        if not tgt_l:
            continue
        neg_ptr = np.zeros(len(neg_lists) + 1, np.int64)
        np.cumsum([len(x) for x in neg_lists], out=neg_ptr[1:])
        hard_ptr = np.zeros(len(hard_lists) + 1, np.int64)
        np.cumsum([len(x) for x in hard_lists], out=hard_ptr[1:])
        out[structure] = dict(
            node_entity=np.stack(ne_l),
            node_mode=np.stack(nm_l),
            edge_rel=np.stack(er_l),
            edge_norm=np.stack(en_l),
            target=np.asarray(tgt_l, np.int32),
            formula_id=np.asarray(fid_l, np.int32),
            neg_pool=(np.concatenate(neg_lists) if neg_ptr[-1]
                      else np.zeros(0, np.int32)),
            neg_ptr=neg_ptr,
            hard_pool=(np.concatenate(hard_lists) if hard_ptr[-1]
                       else np.zeros(0, np.int32)),
            hard_ptr=hard_ptr,
            n_formulas=np.int32(n_formulas),
        )
    return EvalSet(by_structure=out)


def _pad_chunk(a: np.ndarray, lo: int, hi: int, B: int, device,
               fill=0) -> torch.Tensor:
    """Rows [lo, hi) of ``a`` padded to bucket size ``B`` with ``fill``,
    on ``device``."""
    padded = np.full((B,) + a.shape[1:], fill, a.dtype)
    padded[:hi - lo] = a[lo:hi]
    return torch.from_numpy(padded).to(device)


def _sample_csr(pool, ptr, n_neg, rng):
    """[Nq, n_neg] samples (with replacement) + mask from CSR pools."""
    cnt = np.diff(ptr)
    n_q = cnt.shape[0]
    safe = np.maximum(cnt, 1)
    r = rng.integers(0, 1 << 62, (n_q, n_neg)) % safe[:, None]
    idx = ptr[:-1, None] + r
    neg = pool[np.minimum(idx, max(pool.shape[0] - 1, 0))].astype(np.int32)
    mask = (cnt > 0).astype(np.float32)[:, None] * np.ones(
        (1, n_neg), np.float32)
    return neg, mask


def _apr_percentiles(pos, neg, mask):
    """Per-query percentile of pos among its masked negatives."""
    m = mask > 0
    cnt = m.sum(axis=1)
    below = ((neg < pos[:, None]) & m).sum(axis=1) + 0.5 * (
        (neg == pos[:, None]) & m).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        perc = 100.0 * below / cnt
    return perc[cnt > 0]


def _k3_operands(model, cfg):
    """K3's operands for an MPQE model that can take it, else None."""
    from mpqe_tpu_torch.ops.fused_fwd import prepare_fused_multi

    if is_mpqe(cfg) and cfg.readout == "tgt" and cfg.num_bases is not None:
        return prepare_fused_multi(model, cfg)
    return None


def _score_batch(model, cfg, structure, ne, nm, er, en, tgt, neg, operands,
                 neighbor_table=None):
    """(pos scores [B], neg scores [B, K]) through the per-query-relation
    encoder (K3 for eligible MPQE models; ``gqe.score_pos_neg`` for the
    GQE baselines)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    if not is_mpqe(cfg):
        from mpqe_tpu_torch.models import gqe as gqe_mod

        return gqe_mod.score_pos_neg(model, cfg, structure, ne, er, tgt, neg,
                                     neighbor_table)
    q = mpqe_mod.encode_dense_multi_auto(model, cfg, structure, ne, nm, er,
                                         en, operands=operands)
    ent = model.emb.ent
    pos = mpqe_mod.score(cfg, q, mpqe_mod._entity_rows(ent, tgt))
    negs = mpqe_mod.score(cfg, q[:, None, :], mpqe_mod._entity_rows(ent, neg))
    return pos, negs


def evaluate_batched(
    model,
    cfg,
    eval_set: EvalSet,
    n_neg: int = 64,
    max_batch: int = 8192,
    seed: int = 0,
    neighbor_table=None,
) -> EvalResult:
    """One encode+score sweep per structure (chunked at ``max_batch``) on
    the model's device; metrics reduced with numpy.  ``cfg`` is an
    ``MPQEConfig`` or a ``GQEConfig``; ``neighbor_table`` serves a GQE
    neighborhood anchor encoder (train and evaluation must agree).  GQE
    batches are not capped, as in the reference, though a bilinear hop
    gathers ``[B, d, d]`` per edge slot."""
    device = model.emb.ent.device
    auc_s: Dict[str, float] = {}
    apr_s: Dict[str, float] = {}
    hard_s: Dict[str, float] = {}
    rng = np.random.default_rng(seed)
    if is_mpqe(cfg) and cfg.num_bases is None:
        # full-weight models gather [B, d, do] per edge slot
        max_batch = _effective_max_batch(cfg, max_batch,
                                         cfg.embed_dim * cfg.embed_dim)
    operands = _k3_operands(model, cfg)

    def sweep(data, negs):
        n_q = data["target"].shape[0]
        pos_all = np.zeros(n_q, np.float32)
        neg_all = np.zeros((n_q, negs.shape[1]), np.float32)
        for lo in range(0, n_q, max_batch):
            hi = min(lo + max_batch, n_q)
            B = bucket_size(hi - lo)
            with torch.no_grad():
                p_s, n_s = _score_batch(
                    model, cfg, structure,
                    _pad_chunk(data["node_entity"], lo, hi, B, device),
                    _pad_chunk(data["node_mode"], lo, hi, B, device),
                    _pad_chunk(data["edge_rel"], lo, hi, B, device),
                    _pad_chunk(data["edge_norm"], lo, hi, B, device, 1),
                    _pad_chunk(data["target"], lo, hi, B, device),
                    _pad_chunk(negs, lo, hi, B, device), operands,
                    neighbor_table)
            pos_all[lo:hi] = p_s.cpu().numpy()[:hi - lo]
            neg_all[lo:hi] = n_s.cpu().numpy()[:hi - lo]
        return pos_all, neg_all

    for structure, data in eval_set.by_structure.items():
        negs, mask = _sample_csr(data["neg_pool"], data["neg_ptr"], n_neg,
                                 rng)
        pos_all, neg_all = sweep(data, negs)
        fid = data["formula_id"]
        f_aucs = []
        for f in range(int(data["n_formulas"])):
            sel = fid == f
            msel = mask[sel] > 0
            a = roc_auc(pos_all[sel][msel.any(axis=1)], neg_all[sel][msel])
            if np.isfinite(a):
                f_aucs.append(a)
        if f_aucs:
            auc_s[structure] = float(np.mean(f_aucs))
        perc = _apr_percentiles(pos_all, neg_all, mask)
        if perc.size:
            apr_s[structure] = float(np.mean(perc))

        if structure in INTERSECTION_STRUCTURES and data["hard_ptr"][-1]:
            has_hard = np.diff(data["hard_ptr"]) > 0
            hneg, hmask = _sample_csr(data["hard_pool"], data["hard_ptr"],
                                      n_neg, rng)
            hmask = hmask * has_hard[:, None]
            # hard negatives share the query vectors; one more sweep
            _, hneg_s = sweep(data, hneg)
            f_hard = []
            for f in range(int(data["n_formulas"])):
                sel = (fid == f) & has_hard
                if not sel.any():
                    continue
                msel = hmask[sel] > 0
                a = roc_auc(pos_all[sel][msel.any(axis=1)], hneg_s[sel][msel])
                if np.isfinite(a):
                    f_hard.append(a)
            if f_hard:
                hard_s[structure] = float(np.mean(f_hard))
    return EvalResult(auc_s, apr_s, hard_s)


def _encode_and_score(model, cfg, formula: Formula, queries: Sequence[Query],
                      n_neg: int, use_hard: bool, encode_fn: Callable
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pos scores ``[n_q]``, neg scores ``[n_q, K]``, neg mask) of one
    formula's queries: a padded dense batch (negatives from
    ``default_rng(0)``, as the reference draws them), encoded by
    ``encode_fn(model, cfg, structure, node_entity, node_mode, edge_rel,
    edge_norm)`` on the model's device."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    b = make_dense_batch(formula, queries, batch_size=bucket_size(len(queries)),
                         n_neg=n_neg, use_hard_negatives=use_hard,
                         rng=np.random.default_rng(0))
    dev = model.emb.ent.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with torch.no_grad():
        q = encode_fn(model, cfg, b.structure, t(b.node_entity),
                      t(b.node_mode), t(b.edge_rel), t(b.edge_norm))
        ent = model.emb.ent
        tgt = mpqe_mod._entity_rows(ent, t(b.target))
        negs = mpqe_mod._entity_rows(ent, t(b.negatives))
        if is_mpqe(cfg):
            pos = mpqe_mod.score(cfg, q, tgt)
            neg = mpqe_mod.score(cfg, q[:, None, :], negs)
        else:
            from mpqe_tpu_torch.models import gqe as gqe_mod

            pos = gqe_mod.score_rep(cfg, q, tgt, expand=False)
            neg = gqe_mod.score_rep(cfg, q, negs, expand=True)
    n_q = b.n_queries
    return (pos.cpu().numpy()[:n_q], neg.cpu().numpy()[:n_q],
            b.neg_mask[:n_q])


def evaluate(
    model,
    cfg,
    queries_by_structure: Dict[str, Dict[Formula, List[Query]]],
    n_neg: int = 64,
    max_queries_per_formula: Optional[int] = 1000,
    encode_fn: Optional[Callable] = None,
) -> EvalResult:
    """AUC + APR per structure (macro over formulas), hard-negative AUC
    for intersections: the reference's per-formula protocol, one
    ``encode_fn`` call per formula (and one more for its hard negatives).
    ``encode_fn`` defaults to the f32 ``encode_dense`` of an MPQE model.
    A GQE model is evaluated here only through its own ``encode_fn`` (the
    reference's quality benchmark passes ``gqe.encode_dense``), scored by
    its decoder; otherwise it takes :func:`evaluate_batched`."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    if not is_mpqe(cfg) and encode_fn is None:
        raise ValueError(
            f"evaluate takes an MPQEConfig, not {type(cfg).__name__}, "
            "unless encode_fn is given: evaluate GQE models with "
            "evaluate_batched")
    if encode_fn is None:
        encode_fn = mpqe_mod.encode_dense
    auc_s: Dict[str, float] = {}
    apr_s: Dict[str, float] = {}
    hard_s: Dict[str, float] = {}
    for structure, by_formula in queries_by_structure.items():
        f_aucs: List[float] = []
        f_hard: List[float] = []
        percentiles: List[float] = []
        for formula, qs in by_formula.items():
            if max_queries_per_formula:
                qs = qs[:max_queries_per_formula]
            qs = [q for q in qs if q.neg_samples]
            if not qs:
                continue
            pos, neg, mask = _encode_and_score(model, cfg, formula, qs, n_neg,
                                               False, encode_fn)
            valid = mask > 0
            a = roc_auc(pos[valid.any(axis=1)], neg[valid])
            if np.isfinite(a):
                f_aucs.append(a)
            percentiles.extend(_apr_percentiles(pos, neg, mask).tolist())
            if structure in INTERSECTION_STRUCTURES:
                qs_h = [q for q in qs if q.hard_neg_samples]
                if qs_h:
                    pos_h, neg_h, mask_h = _encode_and_score(
                        model, cfg, formula, qs_h, n_neg, True, encode_fn)
                    vh = mask_h > 0
                    ah = roc_auc(pos_h[vh.any(axis=1)], neg_h[vh])
                    if np.isfinite(ah):
                        f_hard.append(ah)
        if f_aucs:
            auc_s[structure] = float(np.mean(f_aucs))
        if percentiles:
            apr_s[structure] = float(np.mean(percentiles))
        if f_hard:
            hard_s[structure] = float(np.mean(f_hard))
    return EvalResult(auc_s, apr_s, hard_s)


def _rank_all_impl(model, cfg, structure, ne, nm, er, en, operands=None,
                   neighbor_table=None):
    """``[B, n_entities]`` scores of a chunk (MPQE: the per-query-relation
    encoder, K3 for eligible models, then every entity; GQE:
    ``gqe.rank_scores``, the box and bibox heads against the raw table,
    SoftAnd by the minimum over its branches' score matrices)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    if not is_mpqe(cfg):
        from mpqe_tpu_torch.models import gqe as gqe_mod

        return gqe_mod.rank_scores(model, cfg, structure, ne, er,
                                   neighbor_table)
    q = mpqe_mod.encode_dense_multi_auto(model, cfg, structure, ne, nm, er,
                                         en, operands=operands)
    return mpqe_mod.score_all_entities(model, cfg, q)


def _rank_counts_impl(model, cfg, structure, ne, nm, er, en, target, emode,
                      operands=None, neighbor_table=None) -> torch.Tensor:
    """Rank on the device: ``1 + #(same-mode candidates scoring strictly
    above the true answer)``, ``[B]``; only that vector leaves the
    device."""
    scores = _rank_all_impl(model, cfg, structure, ne, nm, er, en, operands,
                            neighbor_table)
    t = target.long()
    mode_ok = emode[None, :] == emode[t][:, None]
    true_s = torch.gather(scores, 1, t[:, None])
    return 1 + torch.sum((scores > true_s) & mode_ok, dim=1)


def full_ranking(
    model,
    cfg,
    queries_by_structure: Dict[str, Dict[Formula, List[Query]]],
    entity_mode: np.ndarray,
    hits_at: Tuple[int, ...] = (1, 3, 10),
    max_queries_per_formula: Optional[int] = 200,
    max_batch: int = 8192,
    neighbor_table=None,
) -> Dict[str, Dict[str, float]]:
    """Full-candidate ranking metrics (MRR, mean rank, Hits@K) per
    structure: every entity of the target's mode competes (unfiltered),
    all formulas of a structure in one dispatch per ``max_batch`` chunk
    (capped so one chunk's score matrix stays near 1 GiB).  ``cfg`` and
    ``neighbor_table`` as for :func:`evaluate_batched`.  A row-sharded
    table is refused (its ranking is :func:`full_ranking_sharded`'s)
    rather than assembled on one device."""
    if not isinstance(model.emb.ent, torch.Tensor):
        raise ValueError("the entity table is row-sharded: rank it with "
                         "full_ranking_sharded")
    operands = _k3_operands(model, cfg)
    device = model.emb.ent.device
    es = make_eval_set(queries_by_structure, max_queries_per_formula,
                       require_negatives=False)
    emode = torch.from_numpy(
        np.asarray(entity_mode).astype(np.int32)).to(device)
    max_batch = _effective_max_batch(cfg, max_batch, cfg.n_entities)
    out: Dict[str, Dict[str, float]] = {}
    for structure, data in es.by_structure.items():
        n_q = data["target"].shape[0]
        ranks = np.zeros(n_q, np.float64)
        for lo in range(0, n_q, max_batch):
            hi = min(lo + max_batch, n_q)
            B = bucket_size(hi - lo)
            with torch.no_grad():
                r = _rank_counts_impl(
                    model, cfg, structure,
                    _pad_chunk(data["node_entity"], lo, hi, B, device),
                    _pad_chunk(data["node_mode"], lo, hi, B, device),
                    _pad_chunk(data["edge_rel"], lo, hi, B, device),
                    _pad_chunk(data["edge_norm"], lo, hi, B, device, 1),
                    _pad_chunk(data["target"], lo, hi, B, device), emode,
                    operands, neighbor_table)
            ranks[lo:hi] = r.cpu().numpy()[:hi - lo]
        if n_q:
            out[structure] = _rank_metrics(ranks, hits_at)
    return out


def _rank_metrics(ranks: np.ndarray, hits_at: Tuple[int, ...]
                  ) -> Dict[str, float]:
    m: Dict[str, float] = {
        "mrr": float(np.mean(1.0 / ranks)),
        "mean_rank": float(ranks.mean()),
    }
    for k in hits_at:
        m[f"hits@{k}"] = float(np.mean(ranks <= k))
    return m


def full_ranking_sharded(
    model,
    cfg,
    queries_by_structure: Dict[str, Dict[Formula, List[Query]]],
    entity_mode: np.ndarray,
    mesh,
    hits_at: Tuple[int, ...] = (1, 3, 10),
    max_queries_per_formula: Optional[int] = 200,
    max_batch: int = 8192,
) -> Dict[str, Dict[str, float]]:
    """:func:`full_ranking` over an entity table row-sharded on ``mesh``'s
    model axis (MPQE models only; ``ValueError`` otherwise), for tables
    that exceed one card.  The queries encode on the mesh's first device
    through the per-query-relation encoder (K3 for eligible models, its
    anchor rows gathered from their owner blocks into a compact table),
    and the rank count runs per block (``parallel/rank_shard.py``): no
    ``[B, n_entities]`` score matrix exists on any device.  The rank
    semantics are :func:`full_ranking`'s.  The chunk is capped by the
    per-block score rows.  ``model`` is not changed; ranking reuses the
    encode table's blocks (no second copy), only the padded mode vector
    is new."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.parallel import mesh as mesh_lib
    from mpqe_tpu_torch.parallel import rank_shard

    if not is_mpqe(cfg):
        raise ValueError("sharded full ranking supports MPQE configs only")
    sharded = rank_shard.shard_encode_params(model, mesh)
    table = sharded.emb.ent
    modes = rank_shard.shard_modes(mesh, entity_mode, table.n_padded)
    rank_fn = rank_shard.make_sharded_rank_fn(mesh, cfg)
    operands = _k3_operands(sharded, cfg)
    device = table.device
    es = make_eval_set(queries_by_structure, max_queries_per_formula,
                       require_negatives=False)
    n_shards = mesh.shape[mesh_lib.model_axis(mesh)]
    max_batch = _effective_max_batch(
        cfg, max_batch, max(cfg.n_entities // n_shards, 1))
    out: Dict[str, Dict[str, float]] = {}
    for structure, data in es.by_structure.items():
        n_q = data["target"].shape[0]
        ranks = np.zeros(n_q, np.float64)
        for lo in range(0, n_q, max_batch):
            hi = min(lo + max_batch, n_q)
            B = bucket_size(hi - lo)
            with torch.no_grad():
                q = mpqe_mod.encode_dense_multi_auto(
                    sharded, cfg, structure,
                    _pad_chunk(data["node_entity"], lo, hi, B, device),
                    _pad_chunk(data["node_mode"], lo, hi, B, device),
                    _pad_chunk(data["edge_rel"], lo, hi, B, device),
                    _pad_chunk(data["edge_norm"], lo, hi, B, device, 1),
                    operands=operands)
                r = rank_fn(table.blocks, modes, q.to(torch.float32),
                            _pad_chunk(data["target"], lo, hi, B, device))
            ranks[lo:hi] = r.cpu().numpy()[:hi - lo]
        if n_q:
            out[structure] = _rank_metrics(ranks, hits_at)
    return out
