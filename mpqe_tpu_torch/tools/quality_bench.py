#!/usr/bin/env python3
"""Quality benchmark: MPQE-TGT vs GQE-bilinear on identical data
(counterpart of ``tools/quality_bench.py``).

The paper's central comparison (SURVEY.md §6, §A.4): train both models on
the same rule-structured KG and query sets, report per-structure AUC/APR
(+ hard-negative AUC for intersections) on held-out queries.  The
rule-structured KG (``make_rule_kg``) has deterministic relations, so
held-out AUC has a ~1.0 ceiling.  ``build_data`` gives the reference's
KG and queries, bit for bit; the models train through the port's
``run_train`` and are scored by its per-formula ``evaluate``.

Runs on the card unless ``--device cpu``.  Writes one JSON line per model
to stdout and a summary table to ``--out/summary.md``.

  python -m mpqe_tpu_torch.tools.quality_bench --steps 2000 --dim 128 \\
      --bases 16 --train_per_structure 1000 --val_per_structure 100
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import torch

from mpqe_tpu_torch.data.sampler import QuerySampler, make_rule_kg
from mpqe_tpu_torch.models import gqe as gqe_mod
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.queries import STRUCTURE_NAMES, group_queries_by_formula
from mpqe_tpu_torch.serve import resolve_device
from mpqe_tpu_torch.train import evaluation
from mpqe_tpu_torch.train import loop as loop_mod


def build_data(args):
    """Reference protocol (SURVEY.md §A.3/§A.4): 1-chain training covers
    EVERY directed KG edge (train_edges.pkl equivalent), multi-hop train
    queries are sampled, and val queries are held-out multi-hop
    compositions of seen edges (deduplicated against train).

    ``--holdout`` lists structures EXCLUDED from training and evaluated
    zero-shot — the paper's generalization-to-unseen-structure claim."""
    kg = make_rule_kg(
        n_entities=args.entities, n_modes=3, n_base_rels=args.rels,
        out_degree=2, seed=args.seed,
        variant=args.kg_variant, noise=args.kg_noise,
    )
    holdout = set(args.holdout.split(",")) if args.holdout else set()
    sampler = QuerySampler(kg, seed=args.seed + 1)
    train_q = sampler.all_edge_queries(n_neg=32)
    seen = set()
    for s in STRUCTURE_NAMES:
        if s == "1-chain" or s in holdout:
            continue
        qs = sampler.sample_queries(
            s, args.train_per_structure, n_neg=32, n_hard_neg=16)
        train_q += qs
        seen.update(
            (q.formula.structure, q.formula.rels, q.anchors, q.target)
            for q in qs)
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


def train_model(model, kg, train_q, val_q, args, device):
    """(trained model, ``EvalResult`` on ``val_q``) of one arm."""
    tc = loop_mod.TrainConfig(
        lr=args.lr, lr_schedule=args.lr_schedule,
        batch_size=args.batch_size, n_neg=args.n_neg,
        max_steps=args.steps, val_every=max(args.steps // 4, 1),
        patience=100, seed=args.seed,
    )
    if model == "mpqe":
        cfg = mpqe_mod.MPQEConfig(
            n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
            embed_dim=args.dim, n_layers=3,
            num_bases=args.bases or None,  # 0 = full per-relation weights
            readout=args.mpqe_readout,
        )
        init_fn, loss_fn, enc = None, None, None
    else:
        cfg = gqe_mod.GQEConfig(
            n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
            embed_dim=args.dim, decoder=args.gqe_decoder,
            intersection=args.gqe_intersection,
            encoder=args.gqe_encoder,
        )
        init_fn = gqe_mod.init_gqe
        loss_fn, enc = gqe_mod.dense_batch_loss, gqe_mod.encode_dense
        if args.gqe_encoder == "neighborhood":
            from mpqe_tpu_torch.models import aggregators as agg_mod

            nt = agg_mod.build_neighbor_table_device(
                kg, fanout=args.gqe_fanout, seed=args.seed, device=device)
            loss_fn = functools.partial(gqe_mod.dense_batch_loss,
                                        neighbor_table=nt)
            enc = functools.partial(gqe_mod.encode_dense, neighbor_table=nt)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = loop_mod.init_train_state(gen, cfg, tc, device=device,
                                      init_fn=init_fn)
    state = loop_mod.run_train(
        state, cfg, tc, train_q, val_queries=val_q,
        batch_loss_fn=loss_fn, eval_encode_fn=enc, kg=kg,
    )
    res = evaluation.evaluate(state.model, cfg, val_q, n_neg=64,
                              encode_fn=enc)
    return state.model, res


def summary_lines(args, kg, results) -> list:
    """The markdown table of ``summary.md``: per-structure AUC and APR of
    each model, the macro row, then the hard-negative AUCs."""
    title = "# Quality benchmark: MPQE-TGT vs GQE-bilinear"
    if args.kg_variant != "torus" or args.kg_noise:
        title += f" [variant={args.kg_variant}, noise={args.kg_noise}]"
    if args.holdout:
        title += f" (ZERO-SHOT on held-out structures: {args.holdout})"
    lines = [title, "",
             f"Rule KG ({args.kg_variant}): {kg.n_entities} entities, "
             f"{kg.heads.shape[0]} "
             f"triples, {kg.n_base_rels} rels; identical query sets; "
             f"{args.steps} steps each.", "",
             "| structure | " + " | ".join(
                 f"{m} AUC | {m} APR" for m in results) + " |",
             "|---|" + "---|" * (2 * len(results))]
    structures = sorted(
        {s for r in results.values() for s in r.auc_by_structure})
    for s in structures:
        cells = []
        for r in results.values():
            cells.append(f"{r.auc_by_structure.get(s, float('nan')):.3f}")
            cells.append(f"{r.apr_by_structure.get(s, float('nan')):.1f}")
        lines.append(f"| {s} | " + " | ".join(cells) + " |")
    cells = []
    for r in results.values():
        cells.append(f"**{r.macro_auc:.3f}**")
        cells.append(f"**{r.macro_apr:.1f}**")
    lines.append("| **macro** | " + " | ".join(cells) + " |")
    hard = {m: r.hard_auc_by_structure for m, r in results.items()
            if r.hard_auc_by_structure}
    if hard:
        lines += ["", "Hard-negative AUC (intersections):", ""]
        for m, h in hard.items():
            lines.append(f"- {m}: " + ", ".join(
                f"{k}={v:.3f}" for k, v in sorted(h.items())))
    return lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/quality2")
    ap.add_argument("--entities", type=int, default=600)
    ap.add_argument("--rels", type=int, default=6)
    ap.add_argument("--train_per_structure", type=int, default=2000)
    ap.add_argument("--val_per_structure", type=int, default=150)
    ap.add_argument("--steps", type=int, default=20_000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--n_neg", type=int, default=16)
    ap.add_argument("--lr_schedule", default="cosine")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--bases", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--models", default="mpqe,gqe")
    ap.add_argument("--gqe_encoder", default="direct",
                    choices=["direct", "neighborhood"],
                    help="GQE anchor encoder (models/aggregators.py "
                         "GraphSAGE-style when 'neighborhood')")
    ap.add_argument("--gqe_fanout", type=int, default=8)
    ap.add_argument("--mpqe_readout", default="tgt",
                    choices=["tgt", "sum", "max", "concat", "mlp"],
                    help="MPQE readout (the paper's readout-comparison "
                         "axis; TGT is its headline)")
    ap.add_argument("--gqe_decoder", default="bilinear",
                    choices=["bilinear", "transe", "distmult", "box"])
    ap.add_argument("--gqe_intersection", default="deepsets",
                    choices=["min", "mean", "deepsets"])
    ap.add_argument("--holdout", default="",
                    help="comma list of structures excluded from training "
                         "and evaluated zero-shot")
    ap.add_argument("--kg_variant", default="torus",
                    choices=["torus", "warp", "band", "band_seg"],
                    help="rule family (data.sampler.make_rule_kg): torus "
                         "= translations (linear maps, GQE-friendly); "
                         "warp = piecewise translations; band = "
                         "many-to-many row/column relations")
    ap.add_argument("--kg_noise", type=float, default=0.0,
                    help="fraction of tails rewired uniformly")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns ``{model: EvalResult}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    kg, train_q, val_q = build_data(args)
    print(f"KG: {kg.n_entities} entities, {kg.heads.shape[0]} triples, "
          f"{kg.n_base_rels} base rels", file=sys.stderr, flush=True)

    results = {}
    for model in args.models.split(","):
        print(f"training {model}...", file=sys.stderr, flush=True)
        _, res = train_model(model, kg, train_q, val_q, args, device)
        results[model] = res
        print(json.dumps({"model": model, **res.flat()}), flush=True)

    lines = summary_lines(args, kg, results)
    with open(os.path.join(args.out, "summary.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
