#!/usr/bin/env python3
"""AM-scale 3-chain_inter APR (counterpart of ``tools/am_scale_quality.py``):
held-out APR at the AM dataset's scale, ~2M entities and ~20M directed
edges, on the card.

No AM bytes are needed: the KG is the C++ host runtime's
schema-respecting synthetic at AM shape (``--kg random``) or the
rule-structured segment-band KG (``--kg band_seg``, exact answer sets):

  * KG generation, the incoming-edge CSR and the backward-walk query
    sampling run in the C++ host runtime (``data/native.py``);
  * the whole query bank and a directed-edge bank then move to the card
    once, and each step gathers its batch there: indices and negatives
    are drawn on the card from a ``torch.Generator`` seeded from
    ``(seed + 7, i)`` for the phase's step ``i`` (the reference's
    ``fold_in(PRNGKey(seed + 7), i)``), so the trajectory does not depend
    on ``--steps_per_call``;
  * a call of ``--steps_per_call`` steps is a Python loop whose losses
    stay on the card and are read once a call;
  * per-query relations go through ``encode_dense_multi`` (MPQE, plain
    PyTorch as the reference's XLA: no kernel) or the GQE encoder, so one
    loss trains every sampled formula;
  * curriculum: 1-chain burn-in from the edge bank (negatives from the
    target's contiguous mode block), then the structure phase (a
    round-robin over ``--structure``'s list, one call each).

The oracle and the hard-negative bank (``--eval_oracle``,
``--train_hard_negs``: a fork pool of numpy workers) are built before the
first CUDA call: a process must not fork once CUDA is initialised.

Eval: held-out queries (deduplicated against the train bank by row
hash), APR = per-query percentile of the true answer among its sampled
same-mode negatives (``train/evaluation.py``).  One JSON line per phase
(``kg_gen``, ``sampling``, ``oracle_build``, ``hard_bank``, ``burn_in``,
``full``), then the ``result`` line (with ``peak_mem_bytes`` on the
card).  Runs on the card unless ``--device cpu``.

Usage (the defaults are the reference's AM-scale run):
  python -m mpqe_tpu_torch.tools.am_scale_quality
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def dedup_against(train_ents, train_rels, val_ents, val_rels):
    """Drop val rows whose (entities, rels) tuple appears in train."""
    def keys(e, r):
        flat = np.concatenate([e, r], axis=1).astype(np.uint64)
        # order-sensitive polynomial row hash (vectorized)
        h = np.zeros(flat.shape[0], np.uint64)
        for c in range(flat.shape[1]):
            h = h * np.uint64(0x100000001B3) + flat[:, c]
        return h

    seen = np.unique(keys(train_ents, train_rels))
    return ~np.isin(keys(val_ents, val_rels), seen)


class RuleOracle:
    """Exact query answer sets from the KG's forward adjacency: the APR
    ceiling and hard negatives for rule-structured KGs.

    Works on any KnowledgeGraph: builds a sorted (rel, head) -> tails
    index over the base triples and runs the query DAG's closure per
    query.  Hard negatives follow the reference convention (SURVEY.md
    §A.4): entities satisfying a strict subset of the query's conjuncts,
    the union of answer sets with one edge dropped (drops that disconnect
    the target are skipped), minus the true answer set.
    """

    def __init__(self, kg):
        heads = np.asarray(kg.heads, np.int64)
        rels = np.asarray(kg.rels, np.int64)
        tails = np.asarray(kg.tails, np.int64)
        # directed relation ids, as the native sampler's CSR: forward
        # (h, r, t) is rel 2r from h; the inverse is 2r+1 from t
        k_fwd = (2 * rels) * np.int64(kg.n_entities) + heads
        k_inv = (2 * rels + 1) * np.int64(kg.n_entities) + tails
        key = np.concatenate([k_fwd, k_inv])
        dst = np.concatenate([tails, heads]).astype(np.int32)
        order = np.argsort(key, kind="stable")
        self.key = key[order]
        self.tails = dst[order]
        self.n_ent = kg.n_entities
        self.entity_mode = np.asarray(kg.entity_mode)

    def out(self, h: int, r: int) -> np.ndarray:
        k = np.int64(r) * self.n_ent + np.int64(h)
        lo = np.searchsorted(self.key, k, side="left")
        hi = np.searchsorted(self.key, k, side="right")
        return self.tails[lo:hi]

    def outs(self, hs: np.ndarray, r: int) -> np.ndarray:
        if hs.size == 0:
            return hs.astype(np.int32)
        return np.unique(np.concatenate([self.out(int(h), r)
                                         for h in hs]))

    def answers(self, spec, ents: np.ndarray, rels: np.ndarray,
                drop_edge: int = -1) -> np.ndarray:
        """Closure answer set at the target (base-relation ids only:
        the samplers emit forward relations for these structures)."""
        cand = {}
        for s in spec.anchor_slots:
            cand[s] = np.asarray([ents[s]], np.int32)
        pending = [j for j in range(spec.n_edges) if j != drop_edge]
        while pending:
            nxt = []
            for j in pending:
                s, d = spec.edge_src[j], spec.edge_dst[j]
                if s not in cand:
                    nxt.append(j)
                    continue
                reach = self.outs(cand[s], int(rels[j]))
                cand[d] = (reach if d not in cand
                           else np.intersect1d(cand[d], reach))
            if len(nxt) == len(pending):
                break  # remaining edges disconnected from anchors
            pending = nxt
        return cand.get(spec.target_slot,
                        np.empty(0, np.int32)).astype(np.int32)

    def hard_negatives(self, spec, ents, rels, n_hard: int,
                       rng) -> np.ndarray:
        """Up to n_hard entities satisfying a strict subset of the
        conjuncts (one-edge-dropped closures minus the full answers);
        -1-padded."""
        full = self.answers(spec, ents, rels)
        pool = []
        for j in range(spec.n_edges):
            a = self.answers(spec, ents, rels, drop_edge=j)
            if a.size:
                pool.append(a)
        out = np.full(n_hard, -1, np.int32)
        if not pool:
            return out
        cand = np.setdiff1d(np.unique(np.concatenate(pool)), full)
        if cand.size == 0:
            return out
        take = min(n_hard, cand.size)
        out[:take] = rng.choice(cand, size=take, replace=False)
        return out


_POOL_CTX = {}


def _hard_chunk(task):
    lo, hi, n_hard, seed = task
    oracle, spec = _POOL_CTX["oracle"], _POOL_CTX["spec"]
    ents, rels = _POOL_CTX["ents"], _POOL_CTX["rels"]
    rng = np.random.default_rng(seed)
    out = np.full((hi - lo, n_hard), -1, np.int32)
    for i in range(lo, hi):
        out[i - lo] = oracle.hard_negatives(
            spec, ents[i], rels[i], n_hard, rng)
    return out


def build_hard_bank(oracle, spec, ents, rels, n_hard, seed, procs=None):
    """[n, n_hard] strict-subset hard negatives (-1-padded) for a block
    of sampled queries, fork-parallel: the oracle's sorted index is
    shared copy-on-write with the workers.  Call it before CUDA is
    initialised in this process."""
    import multiprocessing as mp

    n = int(ents.shape[0])
    _POOL_CTX.update(oracle=oracle, spec=spec, ents=ents, rels=rels)
    procs = procs or (os.cpu_count() or 1)
    chunk = max(256, -(-n // (procs * 8)))
    tasks = [(lo, min(lo + chunk, n), n_hard, seed + 13 * lo)
             for lo in range(0, n, chunk)]
    try:
        if procs == 1 or len(tasks) == 1:
            parts = [_hard_chunk(t) for t in tasks]
        else:
            with mp.get_context("fork").Pool(procs) as pool:
                parts = pool.map(_hard_chunk, tasks)
    finally:
        _POOL_CTX.clear()
    return np.concatenate(parts, axis=0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--entities", type=int, default=2_000_000)
    ap.add_argument("--modes", type=int, default=8)
    ap.add_argument("--base_rels", type=int, default=16)
    ap.add_argument("--triples", type=int, default=10_000_000,
                    help="undirected triples (directed edges = 2x)")
    ap.add_argument("--kg", default="random", choices=["random", "band_seg"],
                    help="random = schema-respecting synthetic; band_seg = "
                         "rule-structured segment-band KG (the rules "
                         "determine exact answer sets)")
    ap.add_argument("--seg_width", type=int, default=8)
    ap.add_argument("--eval_oracle", action="store_true",
                    help="compute exact answer sets for the held-out "
                         "queries: APR ceiling under the sampled negatives "
                         "+ hard negatives (reference strict-subset "
                         "convention)")
    ap.add_argument("--n_hard_eval", type=int, default=32)
    ap.add_argument("--train_shared_negs", type=int, default=0,
                    metavar="K",
                    help="the structure phase also scores each query "
                         "against K batch-shared uniform candidates (one "
                         "[B,d]@[d,K] product) besides its per-query "
                         "negatives; 0 = off")
    ap.add_argument("--train_shared_strat", action="store_true",
                    help="draw the shared candidates stratified over mode "
                         "blocks (K/n_modes per mode) instead of uniform "
                         "over all entities")
    ap.add_argument("--train_self_adv", type=float, default=0.0,
                    metavar="TAU",
                    help="self-adversarial weighting of the shared "
                         "candidate sweep (RotatE, arXiv:1902.10197 §3.1): "
                         "each query's candidate violations weighted by "
                         "softmax(TAU * score), detached; 0 = uniform")
    ap.add_argument("--train_hard_negs", type=int, default=0,
                    metavar="K",
                    help="train against K sampled strict-subset hard "
                         "negatives per query: a [--hard_bank, K] bank of "
                         "exact one-edge-dropped closure satisfiers is "
                         "packed on the host (RuleOracle, fork-parallel) "
                         "and a hard-negative margin term joins every "
                         "structure-phase step; 0 = off")
    ap.add_argument("--hard_bank", type=int, default=131_072,
                    help="train queries given an oracle hard-negative row")
    ap.add_argument("--hard_weight", type=float, default=1.0,
                    help="weight of the hard-negative margin term")
    ap.add_argument("--hard_batch", type=int, default=0,
                    help="batch for the hard term (0 = --batch_size)")
    ap.add_argument("--hard_margin", type=float, default=0.0,
                    help="margin for the hard-negative term (0 = the "
                         "model's margin)")
    ap.add_argument("--hard_start", type=float, default=0.0,
                    help="fraction of structure-phase steps before the "
                         "hard term switches on")
    ap.add_argument("--eval_train_hard", action="store_true",
                    help="also score the train hard bank in-sample "
                         "(train_hard_apr)")
    ap.add_argument("--train_queries", type=int, default=1_000_000)
    ap.add_argument("--val_queries", type=int, default=16_384)
    ap.add_argument("--edge_bank", type=int, default=4_000_000,
                    help="directed edges on the card for 1-chain")
    ap.add_argument("--structure", default="3-chain_inter")
    ap.add_argument("--model", default="rgcn", choices=["rgcn", "gqe"],
                    help="rgcn = MPQE; gqe = the deepsets baseline under "
                         "the identical protocol and banks")
    ap.add_argument("--gqe_decoder", default="bilinear",
                    choices=["bilinear", "transe", "distmult", "box",
                             "bibox"])
    ap.add_argument("--bibox_w", type=float, default=1.0,
                    help="bibox: weight of the box-affinity term in the "
                         "fused cosine+box score")
    ap.add_argument("--batch_size", type=int, default=65_536)
    ap.add_argument("--n_neg", type=int, default=4)
    ap.add_argument("--n_neg_eval", type=int, default=64)
    ap.add_argument("--burn_in_steps", type=int, default=3000)
    ap.add_argument("--steps", type=int, default=12_000)
    ap.add_argument("--steps_per_call", type=int, default=500)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--bases", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.003)
    ap.add_argument("--structure_weights", default="",
                    help="structure-phase dispatch weights, e.g. "
                         "'3-chain=3,2-chain=2' (unlisted structures "
                         "weight 1): structure s gets w_s calls per "
                         "round-robin cycle")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    return ap.parse_args(argv)


# ---- losses (module level so that tests can hold them to the reference's)


def is_gqe(cfg) -> bool:
    return not hasattr(cfg, "n_layers")


def pos_neg(model, cfg, structure, ne, nm, er, tgt, neg):
    """(pos [B], neg [B, K]) scores: both models train and evaluate
    through the same protocol and banks."""
    import torch

    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    if is_gqe(cfg):
        from mpqe_tpu_torch.models import gqe as gqe_mod

        return gqe_mod.score_pos_neg(model, cfg, structure, ne, er, tgt, neg)
    en = torch.ones(er.shape, dtype=torch.float32, device=er.device)
    q = mpqe_mod.encode_dense_multi(model, cfg, structure, ne, nm, er, en)
    ent = model.emb.ent
    return (mpqe_mod.score(cfg, q, ent[tgt]),
            mpqe_mod.score(cfg, q[:, None, :], ent[neg]))


def encode_for_sweep(model, cfg, structure, ne, nm, er):
    import torch

    if is_gqe(cfg):
        from mpqe_tpu_torch.models import gqe as gqe_mod

        return gqe_mod.encode_dense_multi(model, cfg, structure, ne, nm, er,
                                          None)
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    en = torch.ones(er.shape, dtype=torch.float32, device=er.device)
    return mpqe_mod.encode_dense_multi(model, cfg, structure, ne, nm, er, en)


def _cosine_sweep(cfg, q, rows):
    import torch

    qf, rf = q.float(), rows.float()
    if cfg.scale_scores:
        qf = qf / (torch.linalg.vector_norm(qf, dim=-1, keepdim=True)
                   + 1e-12)
        rf = rf / (torch.linalg.vector_norm(rf, dim=-1, keepdim=True)
                   + 1e-12)
    return qf @ rf.t()


def sweep_scores(cfg, q, rows):
    """[B, K] scores of the queries against shared candidate rows: box
    distances for the box heads, else cosine."""
    if is_gqe(cfg):
        from mpqe_tpu_torch.models import gqe as gqe_mod

        if cfg.decoder == "box":
            return gqe_mod.box_score_rows(cfg, q, rows)
        if cfg.decoder == "bibox":
            return gqe_mod.bibox_score_rows(cfg, q, rows)
    return _cosine_sweep(cfg, q, rows)


def margin_pn(cfg, pos, neg):
    """mean(relu(margin - pos + neg)) over every (query, negative)."""
    import torch

    return torch.mean(torch.relu(cfg.margin - pos[:, None] + neg))


def multi_loss(model, cfg, structure, ne, nm, er, tgt, neg, shared=None,
               self_adv: float = 0.0):
    """The structure phase's margin loss; with ``shared`` (candidate ids
    ``[K]``) plus the batch-shared sweep, a candidate that is the query's
    own target masked, weighted uniformly or by the detached
    ``softmax(self_adv * score)``."""
    import torch

    pos, ng = pos_neg(model, cfg, structure, ne, nm, er, tgt, neg)
    loss = margin_pn(cfg, pos, ng)
    if shared is not None:
        q = encode_for_sweep(model, cfg, structure, ne, nm, er)
        sc = sweep_scores(cfg, q, model.emb.ent[shared])
        viol = torch.relu(cfg.margin - pos[:, None] + sc)
        w = (shared[None, :] != tgt[:, None]).to(viol.dtype)
        if self_adv > 0.0:
            logits = torch.where(w > 0, self_adv * sc,
                                 torch.full_like(sc, -torch.inf))
            p_adv = torch.softmax(logits, dim=1).detach()
            per_q = torch.sum(torch.where(w > 0, p_adv * viol,
                                          torch.zeros_like(viol)), dim=1)
            loss = loss + torch.mean(per_q)
        else:
            loss = loss + torch.sum(viol * w) / torch.clamp(torch.sum(w),
                                                            min=1.0)
    return loss


def chain_loss(model, cfg, emode, anchor, r, tgt, neg):
    """The burn-in's 1-chain margin loss on edges (anchor, r, tgt)."""
    import torch

    ne = torch.stack([anchor, tgt], dim=1)
    return margin_pn(cfg, *pos_neg(model, cfg, "1-chain", ne, emode[ne],
                                   r[:, None], tgt, neg))


def hard_term(model, cfg, structure, hne, hre, hng, emode, margin):
    """Margin term of sampled strict-subset hard negatives ``hng`` (-1
    pads masked)."""
    import torch

    from mpqe_tpu_torch.queries import STRUCTURES

    tgt = hne[:, STRUCTURES[structure].target_slot]
    hpos, hns = pos_neg(model, cfg, structure, hne, emode[hne], hre, tgt,
                        torch.clamp(hng, min=0))
    m = (hng >= 0).to(torch.float32)
    viol = torch.relu(margin - hpos[:, None] + hns) * m
    return torch.sum(viol) / torch.clamp(torch.sum(m), min=1.0)


def step_generator(gen, base: int, i: int):
    """``gen`` reseeded for step ``i`` of a phase: the counterpart of
    ``fold_in(PRNGKey(base), i)`` (a SeedSequence of the pair)."""
    s = np.random.SeedSequence([base, i]).generate_state(1, np.uint64)[0]
    return gen.manual_seed(int(s) & ((1 << 63) - 1))


def run_steps(model, opt, loss_at, start: int, n: int):
    """Steps ``start .. start + n - 1``: value and gradient of
    ``loss_at(i)``, then the optimizer; the losses ``[n]`` stay on the
    device."""
    import torch

    losses = []
    for i in range(start, start + n):
        opt.zero_grad(set_to_none=True)
        loss = loss_at(i)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses)


def print_json(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def run(args, out=print_json):
    """The tool's run: the phase lines and the ``result`` record through
    ``out`` (each a dict, by default printed as a JSON line); returns (result, every step's loss by phase:
    ``{"burn_in": [...], "full": [...]}``)."""
    from mpqe_tpu_torch.data import native
    from mpqe_tpu_torch.queries import STRUCTURES

    if not native.ensure_built():
        raise SystemExit(f"C++ host library unavailable: "
                         f"{native.BUILD_ERROR}")

    t0 = time.perf_counter()
    if args.kg == "band_seg":
        from mpqe_tpu_torch.data.sampler import make_rule_kg

        kg = make_rule_kg(
            n_entities=args.entities, n_modes=args.modes,
            n_base_rels=args.base_rels, seed=args.seed,
            variant="band_seg", seg_width=args.seg_width)
    else:
        kg = native.make_synthetic_kg_native(
            args.entities, args.modes, args.base_rels, args.triples,
            seed=args.seed)
    out({"phase": "kg_gen", "kg": args.kg, "entities": int(kg.n_entities),
         "triples": int(kg.n_triples),
         "directed_edges": int(2 * kg.n_triples),
         "seconds": time.perf_counter() - t0})

    structures = (list(STRUCTURES) if args.structure == "all"
                  else [s.strip() for s in args.structure.split(",")])

    t0 = time.perf_counter()
    csr = native.build_incoming_csr_native(kg)
    tr, va = {}, {}
    for s in structures:
        t = native.sample_queries_native(
            kg, s, args.train_queries, n_neg=args.n_neg,
            seed=args.seed + 1, csr=csr)
        v = native.sample_queries_native(
            kg, s, 2 * args.val_queries, n_neg=args.n_neg_eval,
            seed=args.seed + 2, csr=csr)
        t = {k: x[t["entities"][:, 0] >= 0] for k, x in t.items()}
        v = {k: x[v["entities"][:, 0] >= 0] for k, x in v.items()}
        keep = dedup_against(t["entities"], t["rels"],
                             v["entities"], v["rels"])
        v = {k: x[keep][: args.val_queries] for k, x in v.items()}
        tr[s], va[s] = t, v
        out({"phase": "sampling", "structure": s,
             "train": int(t["entities"].shape[0]),
             "val_heldout": int(v["entities"].shape[0]),
             "seconds": time.perf_counter() - t0})

    # the oracle and the hard bank are built here, before the first CUDA
    # call: the fork pool must not fork a process that initialised CUDA
    oracle = None
    if args.eval_oracle or args.train_hard_negs:
        t0 = time.perf_counter()
        oracle = RuleOracle(kg)
        out({"phase": "oracle_build", "seconds": time.perf_counter() - t0})
    hard_np = {}
    if args.train_hard_negs:
        for s in structures:
            t0 = time.perf_counter()
            n_hb = min(args.hard_bank, int(tr[s]["entities"].shape[0]))
            h = build_hard_bank(oracle, STRUCTURES[s],
                                tr[s]["entities"][:n_hb],
                                tr[s]["rels"][:n_hb], args.train_hard_negs,
                                seed=args.seed + 17)
            has = (h >= 0).any(axis=1)
            out({"phase": "hard_bank", "structure": s,
                 "queries": int(has.sum()), "requested": n_hb,
                 "n_hard": args.train_hard_negs,
                 "fill": float((h[has] >= 0).mean()) if has.any() else 0.0,
                 "seconds": time.perf_counter() - t0})
            if has.any():
                hard_np[s] = {"ents": tr[s]["entities"][:n_hb][has],
                              "rels": tr[s]["rels"][:n_hb][has],
                              "hard": h[has]}
        if not hard_np:
            raise SystemExit("--train_hard_negs: no sampled query has "
                             "a strict-subset satisfier on this KG")

    import torch

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.serve import resolve_device
    from mpqe_tpu_torch.train import loop as loop_mod
    from mpqe_tpu_torch.train.evaluation import _apr_percentiles, roc_auc

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    init_gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.model == "gqe":
        from mpqe_tpu_torch.models import gqe as gqe_mod

        cfg = gqe_mod.GQEConfig(
            n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
            embed_dim=args.dim, decoder=args.gqe_decoder,
            intersection="deepsets", bibox_w=args.bibox_w)
        if args.train_shared_negs and cfg.soft_and:
            raise SystemExit("--train_shared_negs: SoftAnd's conjunct-min "
                             "scoring has no single query vector to sweep")
        model = gqe_mod.init_gqe(init_gen, cfg, device=device)
    else:
        cfg = mpqe_mod.MPQEConfig(
            n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
            embed_dim=args.dim, n_layers=args.layers, num_bases=args.bases,
            readout="tgt")
        model = mpqe_mod.init_mpqe(init_gen, cfg, device=device)
    opt = loop_mod.make_optimizer(loop_mod.TrainConfig(lr=args.lr),
                                  model.parameters())

    # ---- banks on the card
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device).long()

    emode = dev(kg.entity_mode)
    mstart = dev(np.searchsorted(kg.entity_mode, np.arange(kg.n_modes + 1)))
    banks = {}
    for s in structures:
        banks[s] = {"ents": dev(tr[s]["entities"]),
                    "rels": dev(tr[s]["rels"]),
                    "negs": dev(tr[s]["negatives"])}
        if s in hard_np:
            banks[s].update(h_ents=dev(hard_np[s]["ents"]),
                            h_rels=dev(hard_np[s]["rels"]),
                            h_hard=dev(hard_np[s]["hard"]))
    src, rel, dst = kg.directed_edges()
    rng = np.random.default_rng(args.seed + 3)
    pick = rng.choice(src.shape[0], size=min(args.edge_bank, src.shape[0]),
                      replace=False)
    ebank = {"src": dev(src[pick]), "rel": dev(rel[pick]),
             "dst": dev(dst[pick])}
    B, K = args.batch_size, args.n_neg
    N_e = int(ebank["src"].shape[0])
    Bh = args.hard_batch or B
    gen = torch.Generator(device=device)
    hard_from = int(args.hard_start * args.steps)

    def chain_at(i):
        g = step_generator(gen, args.seed + 7, i)
        idx = torch.randint(0, N_e, (B,), generator=g, device=device)
        tgt = ebank["dst"][idx]
        lo = mstart[emode[tgt]]
        width = mstart[emode[tgt] + 1] - lo
        u = torch.randint(0, 1 << 30, (B, K), generator=g, device=device)
        neg = lo[:, None] + u % width[:, None]
        return chain_loss(model, cfg, emode, ebank["src"][idx],
                          ebank["rel"][idx], tgt, neg)

    def multi_at(s):
        data, spec = banks[s], STRUCTURES[s]
        n_q = int(data["ents"].shape[0])
        use_hard = bool(args.train_hard_negs) and "h_ents" in data

        def loss_at(i):
            g = step_generator(gen, args.seed + 7, i)
            idx = torch.randint(0, n_q, (B,), generator=g, device=device)
            ne = data["ents"][idx]
            shared = None
            if args.train_shared_negs:
                kk = args.train_shared_negs
                if args.train_shared_strat:
                    u = torch.randint(0, 1 << 30, (kk,), generator=g,
                                      device=device)
                    sm = torch.arange(kk, device=device) % cfg.n_modes
                    lo = mstart[sm]
                    shared = lo + u % (mstart[sm + 1] - lo)
                else:
                    shared = torch.randint(0, cfg.n_entities, (kk,),
                                           generator=g, device=device)
            loss = multi_loss(model, cfg, s, ne, emode[ne],
                              data["rels"][idx], ne[:, spec.target_slot],
                              data["negs"][idx], shared=shared,
                              self_adv=args.train_self_adv)
            if use_hard and i >= hard_from:
                # the curriculum gate: 0 until hard_start of the
                # structure phase has run (i counts from 0)
                idx_h = torch.randint(0, int(data["h_ents"].shape[0]),
                                      (Bh,), generator=g, device=device)
                loss = loss + args.hard_weight * hard_term(
                    model, cfg, s, data["h_ents"][idx_h],
                    data["h_rels"][idx_h], data["h_hard"][idx_h], emode,
                    args.hard_margin or cfg.margin)
            return loss

        return loss_at

    trajectory = {"burn_in": [], "full": []}

    def drive(loss_at, total, label, schedule=None):
        t0 = time.perf_counter()
        step, si = 0, 0
        while step < total:
            n = min(args.steps_per_call, total - step)
            rec = {"phase": label}
            fn = loss_at
            if schedule is not None:
                s = schedule[si % len(schedule)]
                si += 1
                fn = loss_at[s]
                rec["structure"] = s
            losses = run_steps(model, opt, fn, step, n).tolist()
            trajectory[label] += losses
            step += n
            rec.update(step=step, loss=losses[-1],
                       seconds=time.perf_counter() - t0)
            out(rec)

    drive(chain_at, args.burn_in_steps, "burn_in")

    # the structure phase: a round-robin over structures, one call each;
    # a cycle holds w_s calls of structure s, interleaved
    weights = {s: 1 for s in structures}
    if args.structure_weights:
        for item in args.structure_weights.split(","):
            name, _, w = item.partition("=")
            name = name.strip()
            if name not in weights:
                raise SystemExit(
                    f"--structure_weights: {name!r} not in the trained "
                    f"structure set {sorted(weights)}")
            weights[name] = max(1, int(w))
        cyc = max(weights.values())
        # Bresenham spread: s appears exactly weights[s] times per cycle
        schedule = [s for i in range(cyc) for s in structures
                    if (i + 1) * weights[s] // cyc > i * weights[s] // cyc]
    else:
        schedule = list(structures)
    drive({s: multi_at(s) for s in structures}, args.steps, "full",
          schedule)

    # ---- held-out eval
    CH = 8192

    @torch.no_grad()
    def score_rows(s, ents, rels, neg_idx):
        tslot = STRUCTURES[s].target_slot
        n = ents.shape[0]
        ps_a = np.zeros(n, np.float32)
        ns_a = np.zeros((n, neg_idx.shape[1]), np.float32)
        for lo in range(0, n, CH):
            ne = dev(ents[lo:lo + CH])
            ps, ns = pos_neg(model, cfg, s, ne, emode[ne],
                             dev(rels[lo:lo + CH]), ne[:, tslot],
                             dev(neg_idx[lo:lo + CH]))
            ps_a[lo:lo + CH] = ps.cpu().numpy()
            ns_a[lo:lo + CH] = ns.cpu().numpy()
        return ps_a, ns_a

    def eval_structure(s):
        spec_s = STRUCTURES[s]
        v = va[s]
        n_v = v["entities"].shape[0]
        pos_all, neg_all = score_rows(s, v["entities"], v["rels"],
                                      v["negatives"])
        mask = np.ones_like(neg_all, np.float32)
        res = {"apr": float(np.mean(
                   _apr_percentiles(pos_all, neg_all, mask))),
               # per-query AUC against its own negatives == APR / 100;
               # the pooled Mann-Whitney kept as the reference keeps it
               "auc_pooled": float(roc_auc(pos_all, neg_all)),
               "val_heldout": int(n_v)}
        if args.eval_oracle:
            # exact answer sets from the KG closure: the APR ceiling under
            # these sampled negatives (an ideal model ties negatives that
            # are true answers: 0.5 credit each), and hard negatives by
            # the strict-subset convention scored by the trained model
            t0 = time.perf_counter()
            orng = np.random.default_rng(args.seed + 11)
            ve_i, vr_i, vn_i = v["entities"], v["rels"], v["negatives"]
            ceil_pcts = np.zeros(n_v, np.float64)
            hard = np.full((n_v, args.n_hard_eval), -1, np.int32)
            n_ans = np.zeros(n_v, np.int64)
            for i in range(n_v):
                A = oracle.answers(spec_s, ve_i[i], vr_i[i])
                n_ans[i] = A.size
                c = float(np.isin(vn_i[i], A).sum())
                n = vn_i.shape[1]
                ceil_pcts[i] = 100.0 * (1.0 - 0.5 * c / n)
                hard[i] = oracle.hard_negatives(
                    spec_s, ve_i[i], vr_i[i], args.n_hard_eval, orng)
            res["apr_ceiling"] = float(np.mean(ceil_pcts))
            res["mean_answer_set"] = float(np.mean(n_ans))
            res["apr_vs_ceiling"] = res["apr"] / res["apr_ceiling"]
            hpos, hneg = score_rows(s, ve_i, vr_i, np.where(hard < 0, 0,
                                                            hard))
            hmask = (hard >= 0).astype(np.float32)
            hpct = _apr_percentiles(hpos, hneg, hmask)
            res["hard_apr"] = float(np.mean(hpct)) if hpct.size else None
            res["hard_queries"] = int((hmask.sum(axis=1) > 0).sum())
            res["oracle_seconds"] = time.perf_counter() - t0
        if args.eval_train_hard and s in hard_np:
            hb = hard_np[s]
            n_t = min(16384, hb["ents"].shape[0])
            th = hb["hard"][:n_t]
            tps, tns = score_rows(s, hb["ents"][:n_t], hb["rels"][:n_t],
                                  np.where(th < 0, 0, th))
            tmask = (th >= 0).astype(np.float32)
            tpct = _apr_percentiles(tps, tns, tmask)
            res["train_hard_apr"] = (float(np.mean(tpct)) if tpct.size
                                     else None)
            res["train_hard_queries"] = int((tmask.sum(axis=1) > 0).sum())
        return res

    per_struct = {s: eval_structure(s) for s in structures}

    result = {
        "phase": "result", "model": args.model,
        "structure": args.structure, "kg": args.kg,
        "entities": kg.n_entities, "directed_edges": int(2 * kg.n_triples),
        "train_queries": sum(int(tr[s]["entities"].shape[0])
                             for s in structures),
        "steps": args.steps, "burn_in_steps": args.burn_in_steps,
        "batch": B,
        "backend": device.type,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
    }
    if len(structures) == 1:
        result.update(per_struct[structures[0]])
    else:
        # macro averages over structures (the reference's summary
        # convention); per-structure detail alongside
        def macro(key):
            vals = [per_struct[s][key] for s in structures
                    if per_struct[s].get(key) is not None]
            return float(np.mean(vals)) if vals else None

        result["apr"] = macro("apr")
        result["auc_pooled"] = macro("auc_pooled")
        result["val_heldout"] = sum(per_struct[s]["val_heldout"]
                                    for s in structures)
        if args.eval_oracle:
            result["apr_ceiling"] = macro("apr_ceiling")
            result["apr_vs_ceiling"] = macro("apr_vs_ceiling")
            result["hard_apr"] = macro("hard_apr")
            result["hard_queries"] = sum(
                per_struct[s].get("hard_queries", 0) or 0
                for s in structures)
        result["per_structure"] = per_struct
    out(result)
    return result, trajectory


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
