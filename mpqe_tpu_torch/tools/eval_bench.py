#!/usr/bin/env python3
"""Full-ranking evaluation throughput on the card (counterpart of
``tools/eval_bench.py``): the production ``full_ranking`` step,
``train/evaluation.py _rank_counts_impl`` (the per-query-relation encode
through K3, the ``[B, n_entities]`` f32 score product and the same-mode
count above the true answer), at the flagship shape, timed by
``utils/profiling.py loop_time`` over a loop that threads the ranks into
the next iteration's edge norms.

Only the ``[B]`` rank vector is the step's result; the MRR and Hits
arithmetic on it is host numpy.  Each sweep writes a ``[B, n_entities]``
f32 score matrix (4 GB at B = 1,024 and 10^6 entities); ``full_ranking``
itself chunks at ``_effective_max_batch`` (256 at this entity count).

Prints one JSON line per batch: ``batch``, ``ms_per_sweep``,
``ranked_queries_per_s``, ``scored_candidates_per_s`` and, on the card,
the device ms by kernel (``device_ms``, ``busy_share``, ``kernels``).
The reference logs these figures as text.  Runs on the card unless
``--device cpu``.

  python -m mpqe_tpu_torch.tools.eval_bench [--batches 256,1024]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import (device_fields, device_of,
                                               log, timed)

D = 128
N_ENTITIES = 1_000_000
N_MODES = 4
N_RELS = 266
NUM_BASES = 16
N_LAYERS = 3
STRUCTURE = "3-chain_inter"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "eval_bench")
    ap.add_argument("--batches", default="256,1024")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.queries import STRUCTURES
    from mpqe_tpu_torch.train import evaluation as ev

    spec = STRUCTURES[STRUCTURE]
    cfg = mpqe_mod.MPQEConfig(
        n_entities=N_ENTITIES, n_modes=N_MODES, n_rels=N_RELS,
        embed_dim=D, n_layers=N_LAYERS, num_bases=NUM_BASES, readout="tgt")
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    operands = ev._k3_operands(model, cfg)
    rng = np.random.default_rng(0)
    log(f"device={device_fields(dev)}")

    def put(a):
        return torch.from_numpy(a).to(dev)

    for B in [int(b) for b in args.batches.split(",")]:
        ne = put(rng.integers(0, N_ENTITIES, (B, spec.n_nodes)
                              ).astype(np.int32))
        nm = put(rng.integers(0, N_MODES, (B, spec.n_nodes)
                              ).astype(np.int32))
        er = put(rng.integers(0, N_RELS, (B, spec.n_edges)).astype(np.int32))
        en0 = put(np.ones((B, spec.n_edges), np.float32))
        tgt = put(rng.integers(0, N_ENTITIES, (B,)).astype(np.int32))
        emode = put(rng.integers(0, N_MODES, (N_ENTITIES,)).astype(np.int32))

        def loop(n):
            e = en0
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            with torch.inference_mode():
                for _ in range(n):
                    r = ev._rank_counts_impl(model, cfg, STRUCTURE, ne, nm,
                                             er, e, tgt, emode,
                                             operands=operands)
                    e = e + r[:1].to(e.dtype) * 1e-20
                    acc = acc + r[0].to(torch.float32)
            return acc

        log(f"rank sweep (B={B}, {N_ENTITIES} entities)...")
        rec = timed(loop, dev)
        dt = rec.pop("ms") / 1e3
        log(f"B={B}: {dt * 1e3:.2f} ms/sweep -> {B / dt:.3e} ranked "
            f"queries/s ({B * N_ENTITIES / dt:.3e} scored candidates/s)")
        print(json.dumps({
            "batch": B, "ms_per_sweep": dt * 1e3,
            "ranked_queries_per_s": B / dt,
            "scored_candidates_per_s": B * N_ENTITIES / dt,
            **device_fields(dev), **rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
