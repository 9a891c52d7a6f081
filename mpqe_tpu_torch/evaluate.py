"""Evaluation CLI of the port: ``python -m mpqe_tpu_torch.evaluate``
(counterpart of the root ``evaluate.py``).

Reads a run dir of ``python -m mpqe_tpu_torch.train`` (``config.json``,
``model_config.json``, ``ckpt/step_*``), rebuilds the run's data from its
config, restores the checkpoint (``--ckpt``, else the latest) and prints
one JSON line ``{"checkpoint", "step", "use", **EvalResult.flat()}`` (AUC
and APR per structure, through ``evaluate_batched``), then with
``--ranking`` one ``{"ranking": structure, "mrr", "mean_rank",
"hits@K"...}`` line per structure (``full_ranking``), then with
``--split`` one ``{"bucket": "seen_edges" | "one_new_edge", "n", ...}``
line per non-empty bucket of ``split_one_new_edge`` against the run's KG
(the reference's generalization split).  ``--use test`` scores a
``pkl:`` dataset's ``test_{edges,queries_2,queries_3}.pkl`` (and exits
when it has none); for synthetic and ``npz:`` data, a fresh draw of the
same size from the disjoint sampler seed ``seed + 7919``, as the
reference does.

MPQE and GQE run dirs alike, their models float32 or bfloat16 (as
``model_config.json`` records it; the scores are f32 either way); a GQE
neighborhood model's neighbor table is rebuilt from the run's
``gqe_fanout`` and ``seed``, as it was trained.
Runs on the card unless told otherwise (``--device cpu``); with no card
and no ``--device cpu`` it raises.  ``--ranking --shards N`` (N > 1)
ranks through ``full_ranking_sharded`` over a ``(1, N)`` mesh, the entity
table row-sharded: on the card N distinct cards (fewer exit with the
reference's message), under ``--device cpu`` N parts on the CPU; MPQE
run dirs only (a GQE run gets the reference's ``ValueError``).

  python -m mpqe_tpu_torch.evaluate --run_dir runs/xyz --ranking
  python -m mpqe_tpu_torch.evaluate --run_dir runs/xyz --use test --split
  python -m mpqe_tpu_torch.evaluate --run_dir runs/xyz --use test \\
      --device cpu
  python -m mpqe_tpu_torch.evaluate --run_dir runs/xyz --ranking --shards 4
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from mpqe_tpu_torch.data import loader as loader_mod
from mpqe_tpu_torch.models import build_model
from mpqe_tpu_torch.queries import group_queries_by_formula
from mpqe_tpu_torch.serve import config_from_json, resolve_device
from mpqe_tpu_torch.train import checkpoint as ckpt_mod
from mpqe_tpu_torch.train import evaluation

# the run config keys that decide the data (the root evaluate.py's list)
DATA_KEYS = ("data", "structures", "custom_structures", "seed",
             "syn_entities", "syn_modes", "syn_rels", "syn_triples",
             "syn_train_queries", "syn_val_queries")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", required=True)
    p.add_argument("--ckpt", default=None,
                   help="defaults to the latest in run_dir/ckpt")
    p.add_argument("--split", action="store_true",
                   help="report seen-edges vs one-new-edge buckets")
    p.add_argument("--use", default="val", choices=["val", "test"],
                   help="which held-out set to score: val (default) or "
                        "the test split (test_*.pkl for pkl: data, a "
                        "fresh disjoint-seed draw otherwise)")
    p.add_argument("--n_neg", type=int, default=64)
    p.add_argument("--ranking", action="store_true",
                   help="also report full-candidate MRR / Hits@K per "
                        "structure")
    p.add_argument("--hits_at", default="1,3,10")
    p.add_argument("--shards", type=int, default=0,
                   help=">1: run --ranking over a model-axis mesh of this "
                        "many parts with the entity table row-sharded "
                        "(full_ranking_sharded; MPQE run dirs only): "
                        "distinct cards, or under --device cpu parts on "
                        "the CPU")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless told otherwise")
    args, _ = p.parse_known_args(argv)
    return args


def load_run_data(run_cfg: dict, use: str):
    """(kg, the held-out queries) exactly as the run saw them; ``use ==
    "test"`` reads a ``pkl:`` dataset's test split, and for other data
    draws fresh queries, as many per structure as the val draw, from
    ``QuerySampler(kg, seed + 7919)``."""
    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.train import __main__ as train_cli

    targs = train_cli.parse_args(
        [f"--{k}" if v is True else f"--{k}={v}"
         for k, v in run_cfg.items() if k in DATA_KEYS and v is not None])
    kg, _, val_q = train_cli.load_data(targs)
    if use == "test" and targs.data.startswith("pkl:"):
        d = targs.data[4:]
        test_q = loader_mod.load_split_queries(d, kg, "test")
        if not test_q:
            raise SystemExit(f"--use test: no test_*.pkl under {d}")
        val_q = test_q
    elif use == "test":
        sampler = QuerySampler(kg, seed=targs.seed + 7919)
        per_s = max(1, targs.syn_val_queries // max(len(val_q), 1))
        fresh = []
        for s in val_q:
            fresh += sampler.sample_queries(s, per_s, n_neg=64)
        val_q = group_queries_by_formula(fresh)
    return kg, val_q


def read_run_dir(run_dir: str):
    """(``config.json``, ``model_config.json``) of a run dir, as dicts."""
    with open(os.path.join(run_dir, "config.json")) as f:
        run_cfg = json.load(f)
    with open(os.path.join(run_dir, "model_config.json")) as f:
        mc = json.load(f)
    return run_cfg, mc


def restore_model(run_dir: str, cfg, ckpt, device):
    """(checkpoint dir, its step, the model restored from its
    ``state.pt`` on ``device``): ``ckpt``, else the run's latest;
    ``SystemExit`` when there is none."""
    ckpt = ckpt or ckpt_mod.latest_checkpoint(os.path.join(run_dir, "ckpt"))
    if ckpt is None:
        raise SystemExit("no checkpoint found")
    payload = torch.load(os.path.join(ckpt, ckpt_mod.STATE_FILE),
                         map_location=device, weights_only=True)
    model = build_model(cfg, device=device)
    model.load_state_dict(payload["model"])
    return ckpt, int(payload["step"]), model


def run_neighbor_table(run_cfg: dict, cfg, kg, device):
    """A GQE neighborhood model's neighbor table on ``device``, rebuilt
    from the run's ``gqe_fanout`` and ``seed`` as the run built it; None
    for any other model."""
    if getattr(cfg, "encoder", None) != "neighborhood":
        return None
    from mpqe_tpu_torch.models.aggregators import build_neighbor_table_device

    return build_neighbor_table_device(kg, fanout=run_cfg["gqe_fanout"],
                                       seed=run_cfg["seed"], device=device)


def main(argv=None):
    args = parse_args(argv)
    run_cfg, mc = read_run_dir(args.run_dir)
    cfg = config_from_json(mc)
    device = resolve_device(args.device)
    mesh = None
    if args.shards > 1:
        from mpqe_tpu_torch.parallel import mesh as mesh_lib

        mesh = mesh_lib.cli_mesh((1, args.shards), device,
                                 f"--shards {args.shards}")
    kg, val_q = load_run_data(run_cfg, args.use)
    ckpt, step, model = restore_model(args.run_dir, cfg, args.ckpt, device)
    nbr = run_neighbor_table(run_cfg, cfg, kg, device)

    res = evaluation.evaluate_batched(model, cfg,
                                      evaluation.make_eval_set(val_q),
                                      n_neg=args.n_neg, neighbor_table=nbr)
    print(json.dumps({"checkpoint": ckpt, "step": step,
                      "use": args.use, **res.flat()}), flush=True)
    if args.ranking:
        hits = tuple(int(k) for k in args.hits_at.split(","))
        if mesh is not None:
            rk = evaluation.full_ranking_sharded(
                model, cfg, val_q, kg.entity_mode, mesh, hits_at=hits)
        else:
            rk = evaluation.full_ranking(model, cfg, val_q, kg.entity_mode,
                                         hits_at=hits, neighbor_table=nbr)
        for structure, m in rk.items():
            print(json.dumps({"ranking": structure, **m}), flush=True)
    if args.split:
        flat = [q for by_f in val_q.values() for qs in by_f.values()
                for q in qs]
        seen, new = loader_mod.split_one_new_edge(flat, kg)
        for name, bucket in (("seen_edges", seen), ("one_new_edge", new)):
            if not bucket:
                continue
            r = evaluation.evaluate_batched(
                model, cfg,
                evaluation.make_eval_set(group_queries_by_formula(bucket)),
                n_neg=args.n_neg, neighbor_table=nbr)
            print(json.dumps({"bucket": name, "n": len(bucket),
                              **r.flat()}), flush=True)


if __name__ == "__main__":
    main()
