#!/usr/bin/env python3
"""Steady-state end-to-end training throughput at the flagship shape
(counterpart of ``tools/e2e_train_bench.py``): wall-clock queries/s with
the host's batch packing included, which the device-step benchmarks
leave out.

The path is the production one: ``data/pipeline.py BatchPipeline`` packs
K same-formula batches per item on its producer thread (the C++ packer,
``data/native.py``, where it builds; else the numpy packer, as the
reference falls back), stacks them on a leading ``[K]`` axis and copies
them to the card on a side stream, and the loop takes K steps per call
(``train/loop.py make_multistep_train_step``,
``run_multistep_stacked``).  The store is a synthetic flagship-scale
``FormulaStore`` (10^6 entities, one ``3-chain_inter`` formula,
fallback-pool negatives): the packing is the real per-batch host work,
the model's quality is irrelevant.

Prints one JSON line per phase with the reference's keys: ``store_build``,
``pack_only`` (the packer alone, ``native`` says which ran),
``warmup_dispatch`` and ``steady_state`` (``mean_fetch_wait_s``: the
wait for the pipeline's next stacked, copied batch; ``per_dispatch_s``:
fetch plus the K steps; ``backend`` the torch device type, beside it the
card's name and ``packer``; on the card one more dispatch profiled:
``device_ms`` a dispatch, ``device_ms_per_step``, ``busy_share``,
``kernels``).  Runs on the card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.e2e_train_bench [--dispatches 12]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import (device_fields, device_of,
                                               profile_fields)


def make_flagship_store(n_entities, n_modes, n_rels, n_queries, structure,
                        seed=0):
    """One-formula ``FormulaStore`` with random anchors and targets and
    on-the-fly fallback negatives, mode-consistent (each mode's entities
    are a contiguous id block); the reference's arrays, draw for draw."""
    from mpqe_tpu_torch.data.store import FormulaStore
    from mpqe_tpu_torch.queries import STRUCTURES, Formula

    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    per_mode = n_entities // n_modes
    node_modes = tuple(int(x) for x in rng.integers(0, n_modes, spec.n_nodes))
    rels = tuple(int(x) for x in rng.integers(0, n_rels, spec.n_edges))
    formula = Formula(structure=structure, rels=rels, node_modes=node_modes)

    def draw(mode, size):
        return (mode * per_mode
                + rng.integers(0, per_mode, size)).astype(np.int32)

    anchors = np.stack(
        [draw(node_modes[s], n_queries) for s in spec.anchor_slots], axis=1)
    t_mode = node_modes[spec.target_slot]
    targets = draw(t_mode, n_queries)
    return FormulaStore(
        formula=formula,
        anchors=anchors,
        targets=targets,
        neg_pool=np.zeros((0,), np.int32),
        neg_ptr=np.zeros((n_queries + 1,), np.int64),
        hard_pool=np.zeros((0,), np.int32),
        hard_ptr=np.zeros((n_queries + 1,), np.int64),
        fallback_pool=(t_mode * per_mode
                       + np.arange(per_mode, dtype=np.int32)),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "e2e_train_bench")
    ap.add_argument("--entities", type=int, default=1_000_000)
    ap.add_argument("--modes", type=int, default=4)
    ap.add_argument("--rels", type=int, default=266)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--bases", type=int, default=16)
    ap.add_argument("--structure", default="3-chain_inter")
    ap.add_argument("--batch_size", type=int, default=131_072)
    ap.add_argument("--n_neg", type=int, default=4)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--dispatches", type=int, default=12)
    ap.add_argument("--store_queries", type=int, default=262_144)
    ap.add_argument("--reuse_batch", action="store_true",
                    help="re-dispatch one stacked batch already on the "
                         "device (separates the steps and their dispatch "
                         "from each batch's host packing and copy)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.data import native as native_mod
    from mpqe_tpu_torch.data.pipeline import BatchPipeline
    from mpqe_tpu_torch.data.store import pack_dense_batch_np
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = mpqe_mod.MPQEConfig(
        n_entities=args.entities, n_modes=args.modes, n_rels=args.rels,
        embed_dim=args.dim, n_layers=args.layers, num_bases=args.bases,
        readout="tgt")
    tc = loop_mod.TrainConfig(
        lr=0.01, batch_size=args.batch_size, n_neg=args.n_neg)
    state = loop_mod.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, tc, device=dev)
    multi_step = loop_mod.make_multistep_train_step(cfg, state.optimizer)

    t0 = time.perf_counter()
    fstore = make_flagship_store(
        args.entities, args.modes, args.rels, args.store_queries,
        args.structure)
    print(json.dumps({"phase": "store_build",
                      "seconds": time.perf_counter() - t0,
                      "n_queries": fstore.n_queries}), flush=True)

    # the packer alone (no device work): what the producer thread sustains
    native = native_mod.available()
    pack = native_mod.pack_dense_batch_native if native else \
        pack_dense_batch_np
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    n_pack_probe = 4
    for _ in range(n_pack_probe):
        pick = rng.integers(0, fstore.n_queries,
                            args.batch_size).astype(np.int64)
        pack(fstore, pick, args.batch_size, args.n_neg, 7, False)
    pack_dt = (time.perf_counter() - t0) / n_pack_probe
    print(json.dumps({"phase": "pack_only", "seconds_per_batch": pack_dt,
                      "queries_per_s": args.batch_size / pack_dt,
                      "native": native}), flush=True)

    K = args.steps_per_call
    pipe = BatchPipeline(
        {args.structure: [fstore]}, batch_size=args.batch_size,
        n_neg=args.n_neg, structures=[args.structure], seed=0,
        prefetch=args.prefetch, device=dev, steps_per_call=K).start()
    try:
        # the first dispatch: kernel builds, allocator pools, a full queue
        b0 = next(pipe)
        t0 = time.perf_counter()
        loop_mod.run_multistep_stacked(multi_step, state, b0)
        print(json.dumps({
            "phase": "warmup_dispatch",
            "seconds": time.perf_counter() - t0}), flush=True)

        per_dispatch = []
        t_start = time.perf_counter()
        for _ in range(args.dispatches):
            t0 = time.perf_counter()
            batch = b0 if args.reuse_batch else next(pipe)
            t_fetch = time.perf_counter() - t0
            losses = loop_mod.run_multistep_stacked(multi_step, state, batch)
            t_total = time.perf_counter() - t0
            per_dispatch.append((t_fetch, t_total))
            if not np.isfinite(losses[-1]):
                raise RuntimeError(f"non-finite loss {losses[-1]}")
        wall = time.perf_counter() - t_start

        def dispatches(n):
            for _ in range(n):
                loop_mod.run_multistep_stacked(
                    multi_step, state, b0 if args.reuse_batch else next(pipe))

        # one more dispatch under the profiler: the card's share of it
        prof = profile_fields(dispatches, dev, 1)
    finally:
        pipe.stop()

    n_steps = args.dispatches * K
    fetches = [f for f, _ in per_dispatch]
    print(json.dumps({
        "phase": "steady_state",
        "reuse_batch": bool(args.reuse_batch),
        **device_fields(dev),
        "packer": "native" if native else "numpy",
        "dispatches": args.dispatches,
        "steps_per_call": K,
        "batch": args.batch_size,
        "wall_seconds": wall,
        "seconds_per_step": wall / n_steps,
        "end_to_end_queries_per_s": n_steps * args.batch_size / wall,
        "mean_fetch_wait_s": float(np.mean(fetches)),
        "max_fetch_wait_s": float(np.max(fetches)),
        "per_dispatch_s": [round(t, 4) for _, t in per_dispatch],
        # one profiled dispatch (K steps): device ms, busy share, kernels
        "device_ms_per_step": (None if prof["device_ms"] is None
                               else prof["device_ms"] / K),
        **prof,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
