#!/usr/bin/env python3
"""The MLP (deep-sets) readout's quality against the sum readout's
(counterpart of ``tools/mlp_readout_diag.py``), on a reduced band
protocol with the same data for every arm:

  sum         the control: the pooled input the MLP transforms
  mlp         the readout's own init (w_pre, w_post ~ N(0, 1/d))
  mlp_id      w_pre and w_post near identity (I + 0.05 x the init): the
              readout starts as the sum readout and learns a change
  mlp_he      w_pre He-scaled (N(0, 2/d)) for its ReLU
  mlp_mean    mean pooling in place of the sum (a scale control)
  mlp_lr3e-3  lr 3e-3 (an optimization-stability control)

The data is the reference's (``data/sampler.py make_rule_kg`` band
variant, ``QuerySampler``), bit for bit; each arm trains through
``train/loop.py run_train`` (cosine lr, validation every quarter) and
is scored by ``train/evaluation.py evaluate`` on held-out queries and a
training subset.  ``mlp_he``'s draw comes from a torch generator, not
the reference's JAX key (same distribution, other values).  The readouts
run outside the hand-written kernels (K3 takes TGT models only).

Prints one JSON line per arm with the reference's keys (``arm``,
``readout``, ``lr``, ``val_auc_macro``, ``val_apr_macro``,
``train_auc_macro``).  Runs on the card unless ``--device cpu`` (the
reference runs on the CPU).

  python -m mpqe_tpu_torch.tools.mlp_readout_diag --arms sum,mlp_id
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from mpqe_tpu_torch.tools.probe_common import device_of, log

ARMS = ("sum", "mlp", "mlp_id", "mlp_he", "mlp_mean", "mlp_lr3e-3")


def build_data(args):
    from mpqe_tpu_torch.data.sampler import QuerySampler, make_rule_kg
    from mpqe_tpu_torch.queries import (STRUCTURE_NAMES,
                                        group_queries_by_formula)

    kg = make_rule_kg(n_entities=args.entities, n_modes=3, n_base_rels=6,
                      out_degree=2, seed=args.seed, variant="band")
    sampler = QuerySampler(kg, seed=args.seed + 1)
    train_q = sampler.all_edge_queries(n_neg=32)
    seen = set()
    for s in STRUCTURE_NAMES:
        if s == "1-chain":
            continue
        qs = sampler.sample_queries(s, args.train_per_structure, n_neg=32,
                                    n_hard_neg=16)
        train_q += qs
        seen.update((q.formula.structure, q.formula.rels, q.anchors,
                     q.target) for q in qs)
    val_q = []
    for s in STRUCTURE_NAMES:
        if s == "1-chain":
            continue
        got = 0
        while got < args.val_per_structure:
            q = sampler.sample_query(s, n_neg=64, n_hard_neg=32)
            key = (q.formula.structure, q.formula.rels, q.anchors, q.target)
            if key in seen:
                continue
            seen.add(key)
            val_q.append(q)
            got += 1
    return (kg, group_queries_by_formula(train_q),
            group_queries_by_formula(val_q))


@torch.no_grad()
def init_arm(arm: str, model, seed: int) -> None:
    """The arm's change to a freshly initialized MLP readout, in place."""
    ro = model.readout
    if arm == "mlp_id":
        d = ro.w_post.shape[0]
        eye = torch.eye(d, dtype=ro.w_post.dtype, device=ro.w_post.device)
        ro.w_post.copy_(eye + 0.05 * ro.w_post)
        # w_pre near identity too: relu(x) keeps the positive half of
        # the signal the sum readout pools
        ro.w_pre.copy_(eye + 0.05 * ro.w_pre)
    elif arm == "mlp_he":
        d = ro.w_pre.shape[0]
        gen = torch.Generator(device=ro.w_pre.device).manual_seed(seed + 77)
        ro.w_pre.copy_(torch.randn((d, d), generator=gen,
                                   device=ro.w_pre.device,
                                   dtype=ro.w_pre.dtype) * math.sqrt(2.0 / d))


def mean_pool_readout(orig):
    """``readout_dense`` with the MLP readout's sum pooling replaced by a
    mean; the other readouts as ``orig``."""
    from mpqe_tpu_torch.ops import dtypes

    def patched(kind, ro, x, target_slot):
        if kind == "mlp":
            h = torch.relu(dtypes.matmul(x, ro.w_pre) + ro.b_pre)
            return dtypes.matmul(torch.mean(h, dim=1), ro.w_post) + ro.b_post
        return orig(kind, ro, x, target_slot)

    return patched


def run_arm(arm, kg, train_q, val_q, args, dev):
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.models import readout as readout_mod
    from mpqe_tpu_torch.train import evaluation
    from mpqe_tpu_torch.train import loop as loop_mod

    readout = "sum" if arm == "sum" else "mlp"
    lr = 3e-3 if arm == "mlp_lr3e-3" else args.lr
    tc = loop_mod.TrainConfig(
        lr=lr, lr_schedule="cosine", batch_size=args.batch_size,
        n_neg=args.n_neg, max_steps=args.steps,
        val_every=max(args.steps // 4, 1), patience=100, seed=args.seed)
    cfg = mpqe_mod.MPQEConfig(
        n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
        embed_dim=args.dim, n_layers=3, num_bases=args.bases or None,
        readout=readout)
    state = loop_mod.init_train_state(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, tc,
        device=dev)
    init_arm(arm, state.model, args.seed)
    orig = readout_mod.readout_dense
    if arm == "mlp_mean":
        readout_mod.readout_dense = mean_pool_readout(orig)
    try:
        state = loop_mod.run_train(state, cfg, tc, train_q,
                                   val_queries=val_q, kg=kg)
        res = evaluation.evaluate(state.model, cfg, val_q, n_neg=64)
        train_sub = {
            qt: {f: qs[:20] for f, qs in list(by_f.items())[:4]}
            for qt, by_f in train_q.items() if qt != "1-chain"}
        train_res = evaluation.evaluate(state.model, cfg, train_sub,
                                        n_neg=32)
    finally:
        readout_mod.readout_dense = orig
    row = {
        "arm": arm, "readout": readout, "lr": lr,
        "val_auc_macro": res.macro_auc, "val_apr_macro": res.macro_apr,
        "train_auc_macro": train_res.macro_auc,
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "mlp_readout_diag")
    ap.add_argument("--entities", type=int, default=600)
    ap.add_argument("--train_per_structure", type=int, default=800)
    ap.add_argument("--val_per_structure", type=int, default=100)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--n_neg", type=int, default=16)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--bases", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    arms = args.arms.split(",")
    bad = [a for a in arms if a not in ARMS]
    if bad:
        ap.error(f"unknown arm(s) {bad}; known: {list(ARMS)}")
    dev = device_of(args.device)
    kg, train_q, val_q = build_data(args)
    log(f"KG: {kg.n_entities} entities, {kg.n_rels} rels")
    for arm in arms:
        log(f"=== arm {arm}")
        run_arm(arm, kg, train_q, val_q, args, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
