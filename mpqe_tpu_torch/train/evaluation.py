"""Evaluation: per-structure ROC-AUC and APR (average percentile rank)
(counterpart of ``mpqe_tpu/train/evaluation.py``).

* AUC per formula: scores of true answers vs each query's stored
  negative samples, macro-averaged per query structure; hard-negative
  AUC separately for intersection structures.
* APR: per query, the percentile rank of the true answer's score among
  its negative candidates, averaged.

ROC-AUC is exact (Mann-Whitney U with tie correction).  The batched
sweep encodes all formulas of a structure at once through the
per-query-relation encoder, K3 (``encode_dense_multi_auto``) for
eligible models.  The per-formula ``evaluate`` and ``full_ranking`` are
not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from mpqe_tpu_torch.data.batcher import bucket_size, template_edge_norm
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


def _score_batch(model, cfg, structure, ne, nm, er, en, tgt, neg, operands):
    """(pos scores [B], neg scores [B, K]) through the per-query-relation
    encoder (K3 for eligible models)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

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
) -> EvalResult:
    """One encode+score sweep per structure (chunked at ``max_batch``) on
    the model's device; metrics reduced with numpy.  MPQE models only: a
    GQE config raises (ROADMAP Queue 1 item 4)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops.fused_fwd import prepare_fused_multi

    if not isinstance(cfg, mpqe_mod.MPQEConfig):
        raise NotImplementedError(
            f"evaluate_batched for {type(cfg).__name__}: the GQE family is "
            "ROADMAP Queue 1 item 4")
    device = model.emb.ent.device
    auc_s: Dict[str, float] = {}
    apr_s: Dict[str, float] = {}
    hard_s: Dict[str, float] = {}
    rng = np.random.default_rng(seed)
    if cfg.num_bases is None:
        # full-weight models gather [B, d, do] per edge slot
        max_batch = _effective_max_batch(cfg, max_batch,
                                         cfg.embed_dim * cfg.embed_dim)
    operands = (prepare_fused_multi(model, cfg)
                if cfg.readout == "tgt" and cfg.num_bases is not None
                else None)

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
                    _pad_chunk(negs, lo, hi, B, device), operands)
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
