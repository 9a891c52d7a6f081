#!/usr/bin/env python3
"""Convert a trained reference (PyTorch) checkpoint into a run dir of the
port (counterpart of ``tools/import_torch_checkpoint.py``).

The upstream PyTorch MPQE's only trained artifact is ``torch.save(model.
state_dict())``; this tool maps it onto the port's ``MPQE``
(``data/torch_import.py``: naming rules and caveats there) and writes a
run dir that ``python -m mpqe_tpu_torch.evaluate`` and ``python -m
mpqe_tpu_torch.serve`` read as they read a training run's::

    python -m mpqe_tpu_torch.tools.import_torch_checkpoint \\
        --ckpt /path/to/model.pt --data pkl:/path/to/am --out runs/imported
    python -m mpqe_tpu_torch.evaluate --run_dir runs/imported
    python -m mpqe_tpu_torch.serve --run_dir runs/imported

The run dir holds ``config.json`` (the data flags, ``imported_from``),
``model_config.json`` and ``ckpt/step_0`` (``train/checkpoint.py``, a
fresh optimizer state).  The model's shape (embed_dim, n_layers,
num_bases, relation vocabulary) is inferred from the state dict, or
given by ``--embed_dim``, ``--n_layers`` and ``--num_bases`` for a state
dict whose layer keys only a ``--map`` places; entity and mode counts
come from the dataset.  MPQE checkpoints only: the upstream GQE baselines
register parameters under names that cannot be known here, so they go
through an explicit ``--map`` only.  ``--rel_perm perm.npy`` permutes
relation rows (``ours[r] = theirs[perm[r]]``).  ``--device`` is the card
unless told otherwise (no card and no ``--device cpu``: it raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="torch state_dict file")
    p.add_argument("--out", required=True, help="run dir to create")
    p.add_argument("--data", required=True,
                   help="dataset spec as the train CLI takes it (pkl:<dir>, "
                        "npz:<file>, synthetic): the entity, mode and "
                        "relation id spaces")
    p.add_argument("--structures", default="all")
    p.add_argument("--readout", default="tgt",
                   help="the reference config's readout (not recoverable "
                        "from tensor shapes for tgt/sum/max)")
    p.add_argument("--margin", type=float, default=1.0)
    p.add_argument("--map", default=None, help="JSON key-map overrides")
    p.add_argument("--embed_dim", type=int, default=None,
                   help="with --n_layers and --num_bases: skip shape "
                        "inference (for state dicts whose layer keys do "
                        "not follow the PyG naming; map them with --map)")
    p.add_argument("--n_layers", type=int, default=None)
    p.add_argument("--num_bases", default=None,
                   help="'none' = full per-relation weights, else an int")
    p.add_argument("--rel_perm", default=None,
                   help=".npy permutation: ours[r] = theirs[perm[r]]")
    p.add_argument("--allow_partial", action="store_true",
                   help="keep unmapped params at the port's random init "
                        "(reported)")
    p.add_argument("--seed", type=int, default=0)
    for flag, dv in (("syn_entities", 200), ("syn_modes", 3),
                     ("syn_rels", 6), ("syn_triples", 600),
                     ("syn_train_queries", 100), ("syn_val_queries", 20)):
        p.add_argument(f"--{flag}", type=int, default=dv)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless told otherwise")
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from mpqe_tpu_torch.data import torch_import as ti
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.serve import resolve_device
    from mpqe_tpu_torch.train import __main__ as train_cli
    from mpqe_tpu_torch.train import checkpoint as ckpt_mod
    from mpqe_tpu_torch.train import loop as loop_mod
    from mpqe_tpu_torch.train.metrics import MetricsWriter

    args = parse_args(argv)
    device = resolve_device(args.device)
    sd = ti.load_state_dict(args.ckpt)
    if args.embed_dim is not None or args.n_layers is not None:
        if args.embed_dim is None or args.n_layers is None:
            raise SystemExit(
                "--embed_dim and --n_layers must be given together")
        nb = (None if args.num_bases in (None, "none")
              else int(args.num_bases))
        shape = None  # explicit shape; the relation vocab comes from data
    else:
        if args.num_bases is not None:
            raise SystemExit(
                "--num_bases only applies with --embed_dim/--n_layers "
                "(otherwise the basis count is inferred from the state "
                "dict and an explicit flag would be silently ignored)")
        shape = ti.infer_model_shape(sd)
        nb = shape.num_bases
        print(f"state dict: d={shape.embed_dim} layers={shape.n_layers} "
              f"rels={shape.n_rels} bases={shape.num_bases}",
              file=sys.stderr)

    targs = train_cli.parse_args([
        "--data", args.data, "--structures", args.structures,
        "--seed", str(args.seed),
        *sum((["--" + f, str(getattr(args, f))]
              for f in ("syn_entities", "syn_modes", "syn_rels",
                        "syn_triples", "syn_train_queries",
                        "syn_val_queries")), []),
    ])
    kg, _, _ = train_cli.load_data(targs)
    if shape is not None and kg.n_rels != shape.n_rels:
        raise SystemExit(
            f"relation vocab mismatch: state dict has {shape.n_rels} "
            f"directed relations, dataset has {kg.n_rels} — wrong "
            "dataset, or the reference run used a different direction "
            "convention")

    node_maps = None
    if args.data.startswith("pkl:"):
        with open(os.path.join(args.data[4:], "graph_data.pkl"), "rb") as f:
            _, _, node_maps = pickle.load(f)

    cfg = mpqe_mod.MPQEConfig(
        n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
        embed_dim=args.embed_dim if shape is None else shape.embed_dim,
        n_layers=args.n_layers if shape is None else shape.n_layers,
        num_bases=nb, readout=args.readout, margin=args.margin)
    key_map = None
    if args.map:
        with open(args.map) as f:
            key_map = json.load(f)
    rel_perm = np.load(args.rel_perm) if args.rel_perm else None

    mode_names = kg.mode_names or tuple(
        f"mode{i}" for i in range(kg.n_modes))
    model, report = ti.import_mpqe_params(
        sd, cfg, torch.Generator().manual_seed(args.seed),
        mode_names=mode_names, node_maps=node_maps, key_map=key_map,
        rel_perm=rel_perm, allow_partial=args.allow_partial, device=device)
    for path, src in sorted(report.mapped.items()):
        print(f"  {path:24s} <- {src}", file=sys.stderr)
    if report.missing:
        print(f"  LEFT AT INIT: {report.missing}", file=sys.stderr)
    if report.unused_keys:
        print(f"  unused state-dict keys: {report.unused_keys}",
              file=sys.stderr)

    metrics = MetricsWriter(args.out)
    run_cfg = {k: getattr(targs, k, None)
               for k in ("data", "structures", "custom_structures", "seed",
                         "syn_entities", "syn_modes", "syn_rels",
                         "syn_triples", "syn_train_queries",
                         "syn_val_queries")}
    run_cfg["imported_from"] = os.path.abspath(args.ckpt)
    metrics.write_config(run_cfg)
    metrics.write_config(dataclasses.asdict(cfg), "model_config.json")
    metrics.close()

    state = loop_mod.TrainState(
        model=model,
        optimizer=loop_mod.make_optimizer(loop_mod.TrainConfig(),
                                          model.parameters()), step=0)
    path = ckpt_mod.save_checkpoint(os.path.join(args.out, "ckpt"), state)
    print(f"imported checkpoint -> {path}", file=sys.stderr)
    print(json.dumps({"run_dir": args.out,
                      "mapped": len(report.mapped),
                      "missing": report.missing,
                      "unused_keys": report.unused_keys}), flush=True)
    return model


if __name__ == "__main__":
    main()
