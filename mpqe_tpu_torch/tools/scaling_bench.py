#!/usr/bin/env python3
"""The edge-partitioned R-GCN layer and the sharded full ranking over 1,
2, 4 and 8 parts (counterpart of ``tools/scaling_bench.py``).

``--phase layer``: one layer (``parallel/halo.py``; ``--layer
allgather``: ``rgcn_dst_partitioned``, the halo by all-gather;
``ring``: ``rgcn_ring_halo``, the halo circulated in P - 1 hops) over a
random typed graph, edges/s per part count.  ``--phase rank``:
``parallel/rank_shard.py make_sharded_rank_fn`` over a table
row-sharded across the parts, ranked queries/s.

With ``--device cuda`` (the default) P parts are the first P visible
cards, as the reference's meshes take ``jax.devices()[:P]``, and the
part counts default to 1, 2, 4, ... up to the machine's count of cards:
the records measure scaling across cards (the halo's blocks cross
between cards by peer copies).  A ``--device`` that names one card
(``cuda:0``), or ``cpu``, puts every part on it (``make_mesh(devices=
[card] * P)``, part counts 1, 2, 4 and 8 by default): the parts run one
after another, so those records measure what the partitioning costs on
one device (the per-part launches, the halo copies, the sums across
parts), not scaling.  The reference's keys are kept (``devices`` is the
part count, and the summary's ``efficiency`` compares edges/s with the
1-part run's times P); ``parts_on`` names the device of every part.
Timed by ``utils/profiling.py loop_time``.  Runs on the card unless
``--device cpu``.

  python -m mpqe_tpu_torch.tools.scaling_bench            # 1, 2, 4 cards
  python -m mpqe_tpu_torch.tools.scaling_bench --device cuda:0 \\
      --devices 1 2 4 8                                   # parts of one
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import (device_fields, device_of,
                                               log, timed)


def bench_mesh(devices, n_nodes, n_e, n_rels, d, num_bases,
               layer="allgather") -> dict:
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops.edge_store import build_edge_store
    from mpqe_tpu_torch.parallel import halo
    from mpqe_tpu_torch.parallel import mesh as mesh_lib

    n_dev, dev = len(devices), devices[0]
    rng = np.random.default_rng(0)
    src = rng.integers(0, n_nodes, n_e).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_e).astype(np.int32)
    rel = rng.integers(0, n_rels, n_e).astype(np.int32)
    st = build_edge_store(src, dst, rel, n_nodes, n_rels)
    lp = rgcn_ops.init_rgcn_layer(torch.Generator(device=dev).manual_seed(0),
                                  d, d, n_rels, num_bases, device=dev)
    x = rng.normal(size=(n_nodes, d)).astype(np.float32)
    mesh = mesh_lib.make_mesh((n_dev, 1), devices=devices)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if layer == "ring":
        pe = halo.partition_edges_ring(st, n_parts=n_dev)
        x_pad_np = np.zeros((pe.n_nodes_padded, d), np.float32)
        x_pad_np[: st.n_nodes] = x
        x_pad = put(x_pad_np)
        args = tuple(put(a) for a in (pe.src_local, pe.dst_local, pe.rel,
                                      pe.norm))
        layer_fn = halo.rgcn_ring_halo
    else:
        pe = halo.partition_edges_by_dst(st, n_parts=n_dev)
        x_pad = put(halo.pad_node_features(x, pe))
        args = tuple(put(a) for a in (pe.src, pe.dst_local, pe.rel,
                                      pe.norm))
        layer_fn = halo.rgcn_dst_partitioned

    def loop(n):
        xx, acc = x_pad, torch.zeros((), device=dev)
        with torch.no_grad():
            for _ in range(n):
                out = layer_fn(mesh, lp, xx, *args, n_rels)
                xx, acc = xx + out * 1e-20, acc + out[0, 0]
        return acc

    rec = timed(loop, dev)
    dt = rec.pop("ms") / 1e3
    return {"devices": n_dev, "seconds_per_layer": dt, "edges_per_s": n_e / dt,
            "parts_on": [str(p) for p in devices], **rec}


def bench_rank_mesh(devices, n_entities, batch, d) -> dict:
    """The sharded full-ranking sweep: each part scores ``[B, N / P]``."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.parallel import mesh as mesh_lib
    from mpqe_tpu_torch.parallel import rank_shard

    n_dev, dev = len(devices), devices[0]
    rng = np.random.default_rng(0)
    cfg = mpqe_mod.MPQEConfig(
        n_entities=n_entities, n_modes=4, n_rels=8, embed_dim=d,
        n_layers=1, readout="tgt")
    mesh = mesh_lib.make_mesh((1, n_dev), devices=devices)

    def put(a):
        return torch.from_numpy(a).to(dev)

    ent = put(rng.normal(size=(n_entities, d)).astype(np.float32))
    mode = rng.integers(0, 4, n_entities).astype(np.int32)
    ent_s, mode_s, _ = rank_shard.shard_table(mesh, ent, mode)
    q = put(rng.normal(size=(batch, d)).astype(np.float32))
    tgt = put(rng.integers(0, n_entities, batch).astype(np.int32))
    fn = rank_shard.make_sharded_rank_fn(mesh, cfg)

    def loop(n):
        qq, acc = q, torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(n):
            r = fn(ent_s, mode_s, qq, tgt)
            qq, acc = qq + r[:1].to(qq.dtype) * 1e-20, acc + r[0]
        return acc

    rec = timed(loop, dev)
    dt = rec.pop("ms") / 1e3
    return {"devices": n_dev, "seconds_per_sweep": dt,
            "ranked_queries_per_s": batch / dt,
            "parts_on": [str(p) for p in devices], **rec}


def part_counts(dev: torch.device) -> list:
    """The default part counts: 1, 2, 4, ... up to the visible cards for a
    bare ``cuda`` (distinct cards), else 1, 2, 4 and 8 parts of ``dev``."""
    if dev.type == "cuda" and dev.index is None:
        return [2 ** i for i in range(torch.cuda.device_count().bit_length())]
    return [1, 2, 4, 8]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "scaling_bench")
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="part counts (default: 1, 2, 4, ... up to the "
                         "cards under --device cuda; 1 2 4 8 parts of "
                         "the one device another --device names)")
    ap.add_argument("--nodes", type=int, default=32_768)
    ap.add_argument("--edges", type=int, default=200_000)
    ap.add_argument("--n_rels", type=int, default=64)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--num_bases", type=int, default=16)
    ap.add_argument("--layer", default="allgather",
                    choices=["allgather", "ring"])
    ap.add_argument("--phase", default="layer", choices=["layer", "rank"],
                    help="layer: the halo R-GCN layer; rank: the sharded "
                         "full-ranking sweep (rank_shard)")
    ap.add_argument("--rank_entities", type=int, default=100_000)
    ap.add_argument("--rank_batch", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda: distinct cards, the first P for P parts; "
                         "a card (cuda:0) or cpu: every part on it")
    args = ap.parse_args(argv)
    from mpqe_tpu_torch.tools.dryrun_multichip import part_devices

    dev = device_of(args.device)
    distinct = dev.type == "cuda" and dev.index is None
    sizes = args.devices or part_counts(dev)
    log(f"device={device_fields(dev)} parts={sizes}, "
        f"{'on distinct cards' if distinct else f'all on {dev}'}")
    results = []
    for n_dev in sizes:
        devices = part_devices(n_dev, args.device)
        if args.phase == "rank":
            r = bench_rank_mesh(devices, args.rank_entities, args.rank_batch,
                                args.d)
        else:
            r = bench_mesh(devices, args.nodes, args.edges, args.n_rels,
                           args.d, args.num_bases, layer=args.layer)
        results.append(r)
        print(json.dumps(r), flush=True)
    base = results[0]
    common = {"sizes": [r["devices"] for r in results],
              **device_fields(dev), "parts_on_one_device": not distinct,
              "note": ("distinct cards: scaling across cards" if distinct
                       else "parts of one device: the partitioning's "
                       "cost, not scaling across devices")}
    if args.phase == "rank":
        summary = {
            "metric": "sharded_rank_scaling",
            "ranked_queries_per_s": [
                r["ranked_queries_per_s"] for r in results], **common}
    else:
        summary = {
            "metric": "halo_rgcn_scaling_efficiency",
            "edges_per_s": [r["edges_per_s"] for r in results],
            "efficiency": [
                r["edges_per_s"]
                / (base["edges_per_s"] * r["devices"] / base["devices"])
                for r in results], **common}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
