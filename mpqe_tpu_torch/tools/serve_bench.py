#!/usr/bin/env python3
"""Batched-stream serving throughput at the flagship shape (counterpart
of ``tools/serve_bench.py``): a ``QueryServer`` on the card (10^6
entities, d = 128, 3 layers, 16 bases, TGT readout; random weights from
seed 0) answers a mixed-structure stream of ``--requests`` requests of
``--batch`` queries.  Each request is the real serving path
(``serve.py``): the per-query-relation encode (K3 where the structure is
eligible), the ``[B, n_entities]`` rank product, the mode mask, the
top-k and the host-side packing; ``answer()`` returns the ids on the
host, so the wall time of a request ends with the card's work.

With ``--http_clients N``, N client threads then send ``--requests``
requests of ``--http_batch`` queries each to a local HTTP front end
(``netserve.make_http_server``) over the same server: the network and
cross-request micro-batching path.

Prints one JSON line per phase (``setup``, ``warmup``, ``stream``,
``http_stream``) with the reference's keys; ``backend`` is the torch
device type, ``device_name`` the card's name.  Runs on the card unless
``--device cpu``.

  python -m mpqe_tpu_torch.tools.serve_bench [--batch 256] [--requests 40]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import device_fields, device_of


def random_queries(structures, n_per_structure, n_entities, n_modes,
                   n_rels, seed=0):
    """``{structure: [Query]}``: random formulas, anchors and targets from
    ``np.random.default_rng(seed)``, draw for draw the reference's."""
    from mpqe_tpu_torch.queries import STRUCTURES, Formula, Query

    rng = np.random.default_rng(seed)
    pools = {}
    for s in structures:
        spec = STRUCTURES[s]
        qs = []
        for _ in range(n_per_structure):
            f = Formula(
                s, tuple(int(r) for r in rng.integers(0, n_rels,
                                                      spec.n_edges)),
                tuple(int(m) for m in rng.integers(0, n_modes,
                                                   spec.n_nodes)))
            qs.append(Query(
                f, tuple(int(a) for a in rng.integers(0, n_entities,
                                                      spec.n_anchors)),
                int(rng.integers(0, n_entities)), (), ()))
        pools[s] = qs
    return pools


def block_entity_mode(n_entities: int, n_modes: int) -> np.ndarray:
    """Entity modes in contiguous blocks, the last mode taking the rest."""
    mode = (np.arange(n_entities) //
            max(n_entities // n_modes, 1)).astype(np.int32)
    return np.minimum(mode, n_modes - 1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "serve_bench")
    ap.add_argument("--entities", type=int, default=1_000_000)
    ap.add_argument("--modes", type=int, default=4)
    ap.add_argument("--rels", type=int, default=266)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--bases", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--structures",
                    default="1-chain,2-chain,2-inter,3-chain_inter")
    ap.add_argument("--http_clients", type=int, default=0,
                    help=">0: also run an HTTP phase: this many client "
                         "threads send --requests requests of "
                         "--http_batch queries each to a local netserve "
                         "instance (the network and micro-batching path "
                         "over the same QueryServer)")
    ap.add_argument("--http_batch", type=int, default=32)
    ap.add_argument("--http_wait_ms", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.serve import QueryServer

    cfg = mpqe_mod.MPQEConfig(
        n_entities=args.entities, n_modes=args.modes, n_rels=args.rels,
        embed_dim=args.dim, n_layers=args.layers, num_bases=args.bases,
        readout="tgt")
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    entity_mode = block_entity_mode(args.entities, args.modes)
    server = QueryServer(model, cfg, entity_mode, device=dev)
    structures = args.structures.split(",")
    print(json.dumps({"phase": "setup", "max_batch": server.max_batch,
                      **device_fields(dev)}), flush=True)

    t0 = time.perf_counter()
    server.warmup(structures, batch=args.batch, k=args.k)
    print(json.dumps({"phase": "warmup",
                      "seconds": time.perf_counter() - t0}), flush=True)

    pools = random_queries(structures, 4 * args.batch, args.entities,
                           args.modes, args.rels)
    rng = np.random.default_rng(1)
    lat = []
    for _ in range(args.requests):
        s = structures[int(rng.integers(len(structures)))]
        pool = pools[s]
        req = [pool[int(i)]
               for i in rng.integers(0, len(pool), args.batch)]
        t0 = time.perf_counter()
        ans = server.answer(req, k=args.k)
        lat.append(time.perf_counter() - t0)
        if len(ans) != args.batch or ans[0].entity_ids.shape != (args.k,):
            raise RuntimeError(f"malformed answer: {len(ans)} answers")
    lat_ms = np.asarray(lat) * 1e3
    total_q = args.requests * args.batch
    print(json.dumps({
        "phase": "stream", "batch": args.batch, "k": args.k,
        "requests": args.requests,
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "queries_per_s": float(total_q / (lat_ms.sum() / 1e3)),
    }), flush=True)

    if args.http_clients > 0:
        http_phase(args, server, entity_mode)
    return 0


def http_phase(args, server, entity_mode):
    """Concurrent clients -> netserve HTTP -> micro-batched dispatches.

    The wire's schema check is strict, so the shim KG makes every
    relation mode-0 -> mode-0 and the anchors are mode-0 entities: the
    modes only choose the candidate mask, the ranking work is the same."""
    from mpqe_tpu_torch.graph import KnowledgeGraph
    from mpqe_tpu_torch.netserve import make_http_server
    from mpqe_tpu_torch.queries import STRUCTURES

    n_base = args.rels // 2
    kg_shim = KnowledgeGraph(
        n_entities=args.entities, n_base_rels=n_base,
        entity_mode=entity_mode,
        rel_domain=np.zeros(n_base, np.int32),
        rel_range=np.zeros(n_base, np.int32),
        heads=np.zeros(0, np.int32), rels=np.zeros(0, np.int32),
        tails=np.zeros(0, np.int32))
    httpd = make_http_server(server, kg_shim, "127.0.0.1", 0,
                             default_k=args.k,
                             max_wait_ms=args.http_wait_ms)
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/answer"

    rng = np.random.default_rng(2)
    rng_lock = threading.Lock()
    structures = args.structures.split(",")
    n_mode0 = int(np.sum(entity_mode == 0))

    def make_payload():
        with rng_lock:
            s = structures[int(rng.integers(len(structures)))]
            spec = STRUCTURES[s]
            # entity_mode is block-contiguous: mode-0 ids are [0, n_mode0);
            # every directed relation is 0 -> 0 under the shim schema
            qs = [{"structure": s,
                   "anchors": [int(a) for a in
                               rng.integers(0, n_mode0, spec.n_anchors)],
                   "rels": [int(r) for r in
                            rng.integers(0, 2 * n_base, spec.n_edges)]}
                  for _ in range(args.http_batch)]
        return json.dumps({"queries": qs, "k": args.k}).encode()

    lat, errors = [], []
    lat_lock = threading.Lock()

    def client():
        for _ in range(args.requests):
            body = make_payload()
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            # a failed request is counted in the JSON line, not lost with
            # its thread (which would overstate the throughput)
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    out = json.loads(r.read())
                if len(out["answers"]) != args.http_batch:
                    raise RuntimeError(
                        f"short response: {len(out['answers'])} answers")
            except Exception as e:  # noqa: BLE001 - reported in the line
                with lat_lock:
                    errors.append(f"{type(e).__name__}: {e}")
                continue
            dt = time.perf_counter() - t0
            with lat_lock:
                lat.append(dt)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client)
                   for _ in range(args.http_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.stop()
        serve_thread.join(timeout=10)
    if not lat:
        print(json.dumps({"phase": "http_stream", "error":
                          f"all {len(errors)} requests failed",
                          "first_error": errors[0] if errors else None}),
              flush=True)
        return
    lat_ms = np.asarray(lat) * 1e3
    total_q = len(lat) * args.http_batch  # successful queries only
    with httpd.batcher.stats_lock:
        sizes = list(httpd.batcher.batch_sizes)
        dispatches = httpd.batcher.total_dispatches
    print(json.dumps({
        "phase": "http_stream", "clients": args.http_clients,
        "http_batch": args.http_batch, "k": args.k,
        "wall_s": wall,
        "requests_per_s": float(len(lat) / wall),
        "queries_per_s": float(total_q / wall),
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "dispatches": dispatches,
        "mean_dispatch_queries": float(np.mean(sizes)) if sizes else 0.0,
        "errors": len(errors),
        **({"first_error": errors[0]} if errors else {}),
    }), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
