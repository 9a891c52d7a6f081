"""Training CLI of the port: ``python -m mpqe_tpu_torch.train``
(counterpart of the root ``train.py``).

Same flags and defaults as ``train.py``, plus ``--device`` (the card
unless told otherwise; with no card and no ``--device cpu`` it raises).
The run dir has the reference's layout: ``config.json``,
``model_config.json``, ``metrics.jsonl`` and ``ckpt/step_*``.  SIGTERM
stops the loop at a step boundary, saves the final checkpoint and exits
0; ``--resume`` continues from the latest checkpoint.  The last line is
``final step=... macro_auc=... macro_apr=...``.

``--data synthetic`` samples a random KG, ``--data npz:<kg.npz>`` a KG
file, and ``--data pkl:<dir>`` reads a GQE-layout dataset directory (from
``python -m mpqe_tpu_torch.tools.prepare_dataset``); a ``pkl:`` dataset
without 1-chain training queries trains 1-chain on every edge of its
graph (``stores_from_edges``; ``metrics.jsonl`` logs
``raw_edge_1chain_derived``).  ``--model rgcn`` trains MPQE; ``--model gqe``
and ``gqe_softand`` train the GQE baselines (``--decoder``,
``--intersection``, ``--gqe_encoder``, ``--gqe_aggregator``,
``--gqe_fanout``, ``--bibox_w``), through the dense path only, as in the
reference.  ``--parallel halo_ring|halo_gather`` trains MPQE through the
edge-partitioned halo layers over a ``--mesh`` (default: one part per
card), ``--parallel spmd`` through the data-parallel step with the
entity table row-sharded over the mesh's model axis
(``parallel/spmd.py``; its checkpoints hold the table whole, so the
unsharded CLIs read them).  On the card a ``--mesh`` of N parts needs N
distinct cards; under ``--device cpu`` its N parts all run on the CPU.  ``--dtype bfloat16`` keeps every leaf and Adam moment in bf16
(products with f32 results, as the reference's) on every route: dense,
``--kernel fused_fwd`` (K1/K2), ``--kernel fused`` (K5 on bf16 rows),
``--kernel blocked`` (K6) and ``--parallel halo_*``.
``--shared_negatives K`` trains MPQE against K batch-shared negative
candidates (``--kernel dense`` or ``fused_fwd``; ``--self_adv_tau``
weights them self-adversarially); ``--prefetch N`` packs batches on a
producer thread N ahead and copies them to the card on a stream of its
own; ``--steps_per_call K`` takes K steps per call (also with
``--parallel halo_*``).  Batches come from the C++ packer when it builds
(``data/native.py``), else from the numpy packer; the ``data_loaded``
record of ``metrics.jsonl`` says which (``"native_packer"``).
``--trace N`` writes a ``torch.profiler`` Chrome trace of N steps, after
``--trace_skip`` steps, under ``<run_dir>/trace`` (``trace_start`` and
``trace_done`` in ``metrics.jsonl``), on every ``--kernel`` and
``--parallel`` route.

  python -m mpqe_tpu_torch.train --data synthetic --kernel fused_fwd \\
      --fused_backward pallas --num_bases 16 --steps 2000
  python -m mpqe_tpu_torch.train --kernel blocked --num_bases 16
  python -m mpqe_tpu_torch.train --dtype bfloat16 --kernel fused_fwd \\
      --fused_backward pallas --num_bases 16
  python -m mpqe_tpu_torch.train --dtype bfloat16 --kernel fused \\
      --num_bases 16
  python -m mpqe_tpu_torch.train --data pkl:/data/AIFB --kernel fused_fwd \\
      --fused_backward pallas --num_bases 16
  python -m mpqe_tpu_torch.train --device cpu --embed_dim 16 --steps 20
  python -m mpqe_tpu_torch.train --parallel halo_ring --num_bases 16
  python -m mpqe_tpu_torch.train --parallel spmd --mesh 2,2 --num_bases 16
  python -m mpqe_tpu_torch.train --kernel fused_fwd --fused_backward pallas \\
      --num_bases 16 --prefetch 2 --steps_per_call 8
  python -m mpqe_tpu_torch.train --dtype bfloat16 --kernel fused_fwd \\
      --fused_backward pallas --num_bases 16 --shared_negatives 512
  python -m mpqe_tpu_torch.train --model gqe_softand --decoder bibox \\
      --gqe_encoder neighborhood --gqe_fanout 8
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import signal
import threading
import time

import torch

from mpqe_tpu_torch.data.sampler import QuerySampler, make_random_kg
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.ops.dtypes import parse_dtype
from mpqe_tpu_torch.queries import STRUCTURE_NAMES, group_queries_by_formula
from mpqe_tpu_torch.serve import resolve_device
from mpqe_tpu_torch.train import checkpoint as ckpt_mod
from mpqe_tpu_torch.train import evaluation
from mpqe_tpu_torch.train import loop as loop_mod
from mpqe_tpu_torch.train.metrics import MetricsWriter


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", default="synthetic")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--model", default="rgcn",
                   choices=["rgcn", "gqe", "gqe_softand"])
    p.add_argument("--decoder", default="bilinear",
                   choices=["bilinear", "transe", "distmult", "box", "bibox"])
    p.add_argument("--intersection", default="deepsets",
                   choices=["min", "mean", "deepsets"])
    p.add_argument("--gqe_encoder", default="direct",
                   choices=["direct", "neighborhood"])
    p.add_argument("--gqe_aggregator", default="mean",
                   choices=["mean", "max", "pool"])
    p.add_argument("--bibox_w", type=float, default=1.0)
    p.add_argument("--gqe_fanout", type=int, default=8)
    p.add_argument("--embed_dim", type=int, default=128)
    p.add_argument("--n_layers", type=int, default=3)
    p.add_argument("--num_bases", type=int, default=0,
                   help="0 = full per-relation weights")
    p.add_argument("--readout", default="tgt",
                   choices=["tgt", "sum", "max", "concat", "mlp"])
    p.add_argument("--margin", type=float, default=1.0)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr_schedule", default="const",
                   choices=["const", "cosine", "warmup_cosine"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help=">0 uses adamw (decoupled decay on every param)")
    p.add_argument("--hard_margin", type=float, default=0.0,
                   help="margin of hard-negative batches; 0 = the model "
                        "margin")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--n_neg", type=int, default=1)
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--val_every", type=int, default=1000)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_call", type=int, default=1,
                   help=">1: K train steps per call, their losses read "
                        "once per call")
    p.add_argument("--kernel", default="dense",
                   choices=["dense", "fused", "blocked", "fused_fwd"],
                   help="dense = f32 template encoder (default); fused = "
                        "sparse layers through K5; blocked = sparse bf16 "
                        "layers through K6 (needs --num_bases); fused_fwd "
                        "= forward through K1 (needs --readout tgt); K1, "
                        "K5 and K6 are hand-written CUDA kernels")
    p.add_argument("--shared_negatives", type=int, default=0, metavar="K",
                   help="train against K batch-shared negative candidates "
                        "instead of per-query negatives (a protocol "
                        "variant; rgcn, --kernel dense or fused_fwd); 0 = "
                        "off")
    p.add_argument("--self_adv_tau", type=float, default=0.0, metavar="TAU",
                   help="with --shared_negatives: weight each query's "
                        "candidate violations by softmax(TAU * score), "
                        "detached, instead of the uniform mean; 0 = "
                        "uniform")
    p.add_argument("--fused_backward", default="xla",
                   choices=["xla", "pallas"],
                   help="gradient path of --kernel fused_fwd: xla = "
                        "recompute through the f32 encoder; pallas = K2, "
                        "the hand-written CUDA backward kernel")
    p.add_argument("--fused_block", type=int, default=2048,
                   help="accepted for train.py's flags; no counterpart")
    p.add_argument("--fused_bwd_block", type=int, default=1024,
                   help="accepted for train.py's flags; no counterpart")
    p.add_argument("--parallel", default="none",
                   choices=["none", "spmd", "halo_ring", "halo_gather"])
    p.add_argument("--mesh", default="")
    p.add_argument("--prefetch", type=int, default=0,
                   help=">0: background batch pipeline depth")
    p.add_argument("--warmup", action="store_true",
                   help="one throwaway step per structure before training")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --run_dir")
    p.add_argument("--trace", type=int, default=0,
                   help=">0: capture a torch.profiler trace of this many "
                        "train steps into RUN_DIR/trace (a Chrome trace)")
    p.add_argument("--trace_skip", type=int, default=20,
                   help="steps to run before the trace starts (past the "
                        "kernel builds and warm-up)")
    p.add_argument("--keep_best", type=int, default=3)
    p.add_argument("--structures", default="all",
                   help="comma list or 'all' or 'chains'")
    p.add_argument("--custom_structures", default=None)
    p.add_argument("--syn_entities", type=int, default=500)
    p.add_argument("--syn_modes", type=int, default=3)
    p.add_argument("--syn_rels", type=int, default=6)
    p.add_argument("--syn_triples", type=int, default=5000)
    p.add_argument("--syn_train_queries", type=int, default=2000)
    p.add_argument("--syn_val_queries", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless told otherwise")
    return p.parse_args(argv)


def _register_custom_structures(path: str) -> None:
    """``--custom_structures``: register the JSON file's templates (a list
    of {name, n_anchors, n_vars, edges}); re-registering the identical
    template is a no-op, a different one under a taken name raises."""
    import json

    from mpqe_tpu_torch.queries import STRUCTURES, register_structure

    with open(path) as f:
        for spec in json.load(f):
            edges = [(int(s), int(d)) for s, d in spec["edges"]]
            if spec["name"] in STRUCTURES:
                ex = STRUCTURES[spec["name"]]
                if not (len(ex.anchor_slots) == int(spec["n_anchors"])
                        and len(ex.var_slots) == int(spec["n_vars"])
                        and list(zip(ex.edge_src, ex.edge_dst)) == edges):
                    raise ValueError(
                        f"--custom_structures: {spec['name']!r} is already "
                        "registered with a DIFFERENT template (rename the "
                        "custom structure)")
                continue
            register_structure(spec["name"], spec["n_anchors"],
                               spec["n_vars"], edges)


def load_data(args):
    """(kg, train queries, val queries) of ``--data``, as ``train.py``'s
    ``load_data``: ``synthetic`` and ``npz:<file>`` sample queries over
    the KG; ``pkl:<dir>`` reads a prepared GQE-layout directory
    (``graph_data.pkl``, ``{train,val}_{edges,queries_2,queries_3}.pkl``).
    """
    from mpqe_tpu_torch.data import loader as loader_mod

    if args.custom_structures:
        _register_custom_structures(args.custom_structures)
    structures = (
        list(STRUCTURE_NAMES) if args.structures == "all"
        else (["1-chain", "2-chain", "3-chain"] if args.structures == "chains"
              else args.structures.split(",")))
    if args.data == "synthetic" or args.data.startswith("npz:"):
        if args.data == "synthetic":
            kg = make_random_kg(
                n_entities=args.syn_entities, n_modes=args.syn_modes,
                n_base_rels=args.syn_rels, n_triples=args.syn_triples,
                seed=args.seed)
        else:
            kg = loader_mod.load_kg_npz(args.data[4:])
        sampler = QuerySampler(kg, seed=args.seed)
        per_s_train = max(1, args.syn_train_queries // len(structures))
        per_s_val = max(1, args.syn_val_queries // len(structures))
        train_q, val_q = [], []
        for s in structures:
            train_q += sampler.sample_queries(s, per_s_train, n_neg=32)
            val_q += sampler.sample_queries(s, per_s_val, n_neg=64)
        return (kg, group_queries_by_formula(train_q),
                group_queries_by_formula(val_q))
    if args.data.startswith("pkl:"):
        d = args.data[4:]
        kg, _, _ = loader_mod.load_graph_pickle(
            os.path.join(d, "graph_data.pkl"))
        # 1-chain data comes from {train,val}_edges.pkl; without
        # train_edges.pkl, main() derives the 1-chain training stores
        # from the train graph's edges (stores_from_edges)
        train_q = loader_mod.load_split_queries(d, kg, "train")
        val_q = loader_mod.load_split_queries(d, kg, "val")
        return kg, train_q, val_q
    raise ValueError(f"unknown --data {args.data}")


def raw_edge_stores(args, kg, train_q):
    """The training stores of a ``pkl:`` dataset that ships no 1-chain
    training queries while 1-chain is trained: ``build_stores`` of its
    queries plus one raw-edge store per directed relation
    (``stores_from_edges``), as ``train.py`` derives them; else None."""
    from mpqe_tpu_torch.data.store import build_stores, stores_from_edges

    want_1chain = (args.structures in ("all", "chains")
                   or "1-chain" in args.structures.split(","))
    if not (args.data.startswith("pkl:") and want_1chain
            and "1-chain" not in train_q):
        return None
    stores = build_stores(train_q, kg=kg)
    stores.update(stores_from_edges(kg))
    return stores


def _refuse_parallel_combinations(args) -> None:
    """``SystemExit`` with train.py's messages for what ``--parallel``
    does not combine with."""
    if args.parallel == "none":
        return
    if args.model != "rgcn":
        raise SystemExit("--parallel requires --model rgcn")
    if args.kernel != "dense":
        raise SystemExit(
            "--kernel {fused,blocked} is single-chip for now; the "
            "distributed steps (--parallel) own their own layer path")
    if args.shared_negatives:
        raise SystemExit(
            "--shared_negatives is single-chip for now; the "
            "distributed steps own their own loss")


def _refuse_gqe_combinations(args) -> None:
    """``SystemExit`` with train.py's messages for what ``--model
    gqe|gqe_softand`` does not combine with."""
    if args.model == "rgcn":
        return
    if args.kernel != "dense":
        raise SystemExit("--kernel applies to --model rgcn only")
    if args.shared_negatives:
        raise SystemExit("--shared_negatives requires --model rgcn")
    if args.self_adv_tau:
        raise SystemExit("--self_adv_tau requires --model rgcn "
                         "--shared_negatives")


def _gqe_setup(args, kg, device):
    """(GQEConfig, batch loss with the neighbor table bound, the table or
    None) of ``--model gqe|gqe_softand``."""
    from mpqe_tpu_torch.models import gqe as gqe_mod

    cfg = gqe_mod.GQEConfig(
        n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
        embed_dim=args.embed_dim, decoder=args.decoder,
        intersection=args.intersection,
        soft_and=args.model == "gqe_softand", encoder=args.gqe_encoder,
        aggregator=args.gqe_aggregator, bibox_w=args.bibox_w,
        margin=args.margin, dtype=parse_dtype(args.dtype))
    table = None
    if args.gqe_encoder == "neighborhood":
        from mpqe_tpu_torch.models import aggregators as agg_mod

        table = agg_mod.build_neighbor_table_device(
            kg, fanout=args.gqe_fanout, seed=args.seed, device=device)
    loss_fn = functools.partial(gqe_mod.dense_batch_loss,
                                neighbor_table=table)
    return cfg, loss_fn, table


def _parallel_mesh(args, device, metrics):
    """The ``--mesh`` of ``--parallel`` (default ``(device count, 1)``:
    every card, or one CPU part): one distinct card per part, or under
    ``--device cpu`` every part on the CPU (``mesh.cli_mesh``)."""
    from mpqe_tpu_torch.parallel import mesh as mesh_lib

    n = torch.cuda.device_count() if device.type == "cuda" else 1
    shape = (tuple(int(x) for x in args.mesh.split(","))
             if args.mesh else (n, 1))
    mesh = mesh_lib.cli_mesh(shape, device, f"--mesh {args.mesh}")
    metrics.log({"event": "mesh", "shape": dict(mesh.shape)})
    return mesh


def main(argv=None):
    args = parse_args(argv)
    _refuse_parallel_combinations(args)
    _refuse_gqe_combinations(args)
    device = resolve_device(args.device)
    if args.kernel == "blocked" and not args.num_bases:
        raise SystemExit("--kernel blocked requires --num_bases")
    if args.kernel == "fused_fwd" and args.readout != "tgt":
        raise SystemExit("--kernel fused_fwd requires --readout tgt")
    run_dir = args.run_dir or os.path.join(
        "runs", time.strftime("%Y%m%d-%H%M%S"))
    metrics = MetricsWriter(run_dir)
    metrics.write_config(vars(args))

    t0 = time.perf_counter()
    kg, train_q, val_q = load_data(args)
    from mpqe_tpu_torch.data import native as native_mod

    metrics.log({"event": "data_loaded", "data": args.data,
                 "seconds": time.perf_counter() - t0,
                 "n_entities": kg.n_entities, "n_triples": kg.n_triples,
                 "native_packer": native_mod.available()})
    init_fn = neighbor_table = None
    if args.model == "rgcn":
        cfg = mpqe_mod.MPQEConfig(
            n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
            embed_dim=args.embed_dim, n_layers=args.n_layers,
            num_bases=args.num_bases or None, readout=args.readout,
            margin=args.margin, dtype=parse_dtype(args.dtype))
        batch_loss_fn = {
            "fused": mpqe_mod.dense_batch_loss_kernel_fused,
            "blocked": mpqe_mod.dense_batch_loss_kernel_blocked,
        }.get(args.kernel)
    else:
        from mpqe_tpu_torch.models import gqe as gqe_mod

        cfg, batch_loss_fn, neighbor_table = _gqe_setup(args, kg, device)
        init_fn = gqe_mod.init_gqe
    if args.kernel == "fused_fwd":
        def batch_loss_fn(*a):
            return mpqe_mod.dense_batch_loss_kernel_fused_fwd(
                *a, backward=args.fused_backward)
    if args.model == "rgcn" and args.shared_negatives:
        if args.kernel not in ("dense", "fused_fwd"):
            raise SystemExit(
                "--shared_negatives requires --kernel dense or fused_fwd")
        batch_loss_fn = mpqe_mod.make_shared_negs_batch_loss(
            args.shared_negatives,
            encoder="fused_fwd" if args.kernel == "fused_fwd" else "dense",
            fused_backward=args.fused_backward,
            self_adv_tau=args.self_adv_tau)
    elif args.self_adv_tau:
        raise SystemExit("--self_adv_tau requires --shared_negatives")
    mesh = None
    if args.parallel != "none":
        mesh = _parallel_mesh(args, device, metrics)
    if args.parallel in ("halo_ring", "halo_gather"):
        from mpqe_tpu_torch.parallel import halo_train

        batch_loss_fn = halo_train.halo_batch_loss_fn(
            mesh, layer_kind="ring" if args.parallel == "halo_ring"
            else "gather")
    tc = loop_mod.TrainConfig(
        lr=args.lr, batch_size=args.batch_size, n_neg=args.n_neg,
        max_steps=args.steps, val_every=args.val_every,
        patience=args.patience, seed=args.seed,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        optimizer=args.optimizer, grad_clip_norm=args.grad_clip,
        weight_decay=args.weight_decay, hard_margin=args.hard_margin)
    metrics.write_config(dataclasses.asdict(cfg), "model_config.json")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    train_step = multi_step = put_batch = None
    if args.parallel == "spmd":
        from mpqe_tpu_torch.parallel import spmd

        spmd_init, train_step = spmd.make_spmd_train_step(
            cfg, tc, mesh, shard_entity_table=True)
        if args.steps_per_call > 1:
            _, multi_step = spmd.make_spmd_multistep_train_step(
                cfg, tc, mesh, shard_entity_table=True)
        put_batch = functools.partial(spmd.put_batch, mesh)
        state = spmd_init(gen)
    else:
        state = loop_mod.init_train_state(gen, cfg, tc, device=device,
                                          init_fn=init_fn)
    ckpt_dir = os.path.join(run_dir, "ckpt")
    if args.resume:
        latest = ckpt_mod.latest_checkpoint(ckpt_dir)
        if latest:
            t0 = time.perf_counter()
            state = ckpt_mod.restore_checkpoint(latest, state)
            metrics.log({"step": state.step, "event": "resumed",
                         "path": latest,
                         "seconds": time.perf_counter() - t0})
        else:
            metrics.log({"event": "resume_requested_no_checkpoint"})
    manager = ckpt_mod.CheckpointManager(ckpt_dir, keep_best=args.keep_best)
    train_stores = raw_edge_stores(args, kg, train_q)
    if train_stores is not None:
        metrics.log({"event": "raw_edge_1chain_derived",
                     "edge_queries": sum(
                         s.n_queries for s in train_stores["1-chain"])})

    def checkpoint_fn(st, metric):
        path = manager.save(st, metric=metric)
        metrics.log({"step": st.step, "event": "checkpoint", "path": path,
                     "val_auc": metric})

    # graceful preemption: SIGTERM stops the loop at the next step
    # boundary; the final checkpoint below makes the run resumable and
    # the exit code is 0
    stop_event = threading.Event()
    prev_sigterm, installed_sigterm = None, False
    if threading.current_thread() is threading.main_thread():
        prev_sigterm = signal.signal(signal.SIGTERM,
                                     lambda s, f: stop_event.set())
        installed_sigterm = True
    try:
        state = loop_mod.run_train(
            state, cfg, tc, train_q, val_queries=val_q,
            should_stop=stop_event.is_set, log_fn=metrics.log,
            checkpoint_fn=checkpoint_fn, batch_loss_fn=batch_loss_fn, kg=kg,
            warmup=args.warmup, neighbor_table=neighbor_table,
            train_stores=train_stores, prefetch=args.prefetch,
            steps_per_call=args.steps_per_call, train_step=train_step,
            multi_step=multi_step, put_batch=put_batch,
            trace=((args.trace_skip, args.trace,
                    os.path.join(run_dir, "trace"))
                   if args.trace > 0 else None))
        # the handler stays installed until the save is done: a second
        # SIGTERM in the grace window is swallowed, not a crash mid-save
        final_path = manager.save(state)
        metrics.log({"step": state.step, "event": "final_checkpoint",
                     "path": final_path})
    finally:
        if installed_sigterm:
            signal.signal(signal.SIGTERM,
                          prev_sigterm if prev_sigterm is not None
                          else signal.SIG_DFL)
    if stop_event.is_set():
        metrics.log({"step": state.step, "event": "preempt_exit"})
        print(f"preempted at step={state.step}; checkpoint saved "
              f"({final_path})")
        metrics.close()
        return state
    res = evaluation.evaluate_batched(state.model, cfg,
                                      evaluation.make_eval_set(val_q),
                                      neighbor_table=neighbor_table)
    metrics.log({"step": state.step, "final": res.flat()})
    print(f"final step={state.step} macro_auc={res.macro_auc:.4f} "
          f"macro_apr={res.macro_apr:.2f}")
    metrics.close()
    return state


if __name__ == "__main__":
    main()
