#!/usr/bin/env python3
"""The native host runtime at scale, then the dense train step
(counterpart of ``tools/big_kg_demo.py``): a synthetic KG of
``--triples`` typed triples over ``--entities`` entities generated in
C++ (``data/native.py make_synthetic_kg_native``), ``--queries``
``3-chain_inter`` queries sampled by its batched backward walk
(``sample_queries_native``), the raw-edge 1-chain stores straight from
the triple arrays (``data/store.py stores_from_edges``) and one batch of
``--batch_size`` packed from the largest by the C++ packer.  With
``--train_steps N`` the dense train step (``dense_batch_loss`` and
``OptaxAdam``, d = 128, 3 layers, 16 bases, the KG's entity count) is
then timed on the card over sampled queries by ``utils/profiling.py
loop_time``.

The defaults (10^7 entities, 10^8 triples) need about 6 GB of host
memory.  The C++ library is built into ``mpqe_tpu_torch/_build/`` at
first use; without it the tool exits, as the reference does.  Prints
one JSON line per phase with the reference's keys (``kg_gen``,
``query_sampling``, ``raw_edge_stores`` with ``packer``, ``train`` with
``backend`` the torch device type and the card's name).  Runs on the
card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.big_kg_demo --train_steps 5
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import device_fields, device_of, timed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "big_kg_demo")
    ap.add_argument("--entities", type=int, default=10_000_000)
    ap.add_argument("--modes", type=int, default=8)
    ap.add_argument("--base_rels", type=int, default=64)
    ap.add_argument("--triples", type=int, default=100_000_000)
    ap.add_argument("--queries", type=int, default=1_000_000)
    ap.add_argument("--structure", default="3-chain_inter")
    ap.add_argument("--batch_size", type=int, default=65_536)
    ap.add_argument("--n_neg", type=int, default=4)
    ap.add_argument("--train_steps", type=int, default=0,
                    help="0 = skip the device training phase")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.data import native
    if not native.ensure_built():
        raise SystemExit("C++ host library unavailable")

    t0 = time.perf_counter()
    kg = native.make_synthetic_kg_native(
        args.entities, args.modes, args.base_rels, args.triples, seed=0)
    t_gen = time.perf_counter() - t0
    print(json.dumps({"phase": "kg_gen", "triples": kg.n_triples,
                      "seconds": t_gen,
                      "triples_per_s": kg.n_triples / t_gen}), flush=True)

    t0 = time.perf_counter()
    out = native.sample_queries_native(
        kg, args.structure, args.queries, n_neg=args.n_neg, seed=1)
    t_s = time.perf_counter() - t0
    ok = out["entities"][:, 0] >= 0
    print(json.dumps({"phase": "query_sampling", "requested": args.queries,
                      "sampled_ok": int(ok.sum()), "seconds": t_s,
                      "queries_per_s": args.queries / t_s}), flush=True)

    # raw-edge 1-chain stores: views of the triple arrays and per-mode
    # fallback pools, no per-edge Python objects
    from mpqe_tpu_torch.data.store import stores_from_edges

    t0 = time.perf_counter()
    stores = stores_from_edges(kg)["1-chain"]
    t_st = time.perf_counter() - t0
    n_edge_q = sum(s.n_queries for s in stores)
    t0 = time.perf_counter()
    big = max(stores, key=lambda s: s.n_queries)
    pick = np.random.default_rng(0).integers(
        0, big.n_queries, args.batch_size).astype(np.int64)
    b = native.pack_dense_batch_native(
        big, pick, args.batch_size, args.n_neg, seed=3)
    t_pk = time.perf_counter() - t0
    if float(b.neg_mask.min()) != 1.0:
        raise RuntimeError("a packed query lacks its fallback negatives")
    print(json.dumps({"phase": "raw_edge_stores", "edge_queries": n_edge_q,
                      "build_seconds": t_st,
                      "pack_batch_seconds": t_pk,
                      "pack_queries_per_s": args.batch_size / t_pk,
                      "packer": "native"}), flush=True)

    if args.train_steps <= 0:
        return 0
    train_phase(args, kg, out, ok, dev)
    return 0


def train_phase(args, kg, out, ok, dev) -> None:
    from mpqe_tpu_torch.bench import _step_loop
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.queries import STRUCTURES
    from mpqe_tpu_torch.train import loop as loop_mod

    spec = STRUCTURES[args.structure]
    cfg = mpqe_mod.MPQEConfig(
        n_entities=args.entities, n_modes=args.modes,
        n_rels=2 * args.base_rels, embed_dim=128, n_layers=3,
        num_bases=16, readout="tgt")
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    optimizer = loop_mod.make_optimizer(loop_mod.TrainConfig(lr=0.01),
                                        model.parameters())
    B = args.batch_size
    ents = out["entities"][ok][:B]
    rels = out["rels"][ok][:B]
    negs = out["negatives"][ok][:B]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    node_entity = put(ents)
    node_mode = put(kg.entity_mode[ents])
    edge_rel = put(rels[0])  # one formula's relations for the whole batch
    edge_norm = put(np.ones((spec.n_edges,), np.float32))
    target = put(ents[:, spec.target_slot])
    negatives = put(negs)
    n_b = int(node_entity.shape[0])
    masks = put(np.ones((n_b, args.n_neg), np.float32))
    qmask = put(np.ones((n_b,), np.float32))

    def loss_fn(m):
        return mpqe_mod.dense_batch_loss(
            m, cfg, args.structure, node_entity, node_mode, edge_rel,
            edge_norm, target, negatives, masks, qmask)

    rec = timed(_step_loop(model, optimizer, loss_fn), dev, n_small=2,
                n_large=2 + args.train_steps)
    dt = rec.pop("ms") / 1e3
    print(json.dumps({"phase": "train", **device_fields(dev),
                      "step_seconds": dt, "queries_per_s": n_b / dt,
                      **rec}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
