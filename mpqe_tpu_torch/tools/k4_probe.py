#!/usr/bin/env python3
"""Measurements behind the K4 findings in PERF.md, on one CUDA card.

``ab TREE [TREE ...]``
    ``eval.sparse`` and ``eval.sparse_max`` of ``chip_smoke.py`` (the
    per-formula ``evaluate`` through ``encode_sparse(segment_backend=
    "pallas")`` over the 448 sampled validation queries, for the flagship
    TGT model and a flagship-width max-readout model, random weights from
    a seed) from each checkout TREE in turn, each in a process of its
    own: ``evaluate`` once to warm the kernels and the allocator, then
    REPEATS timed runs (host clock, ending in a synchronize): every wall
    time, their median and the queries/s at the median.  To compare two
    commits, unpack both (``git archive``) and pass them in turns:
    parent, change, change, parent.

Usage: python3 mpqe_tpu_torch/tools/k4_probe.py ab runs/parent . . runs/parent
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
REPEATS = 7

AB_RUN = r"""
import sys, time, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mpqe_tpu_torch.data.sampler import make_random_kg
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.train import evaluation
torch.backends.cuda.matmul.allow_tf32 = False
cs.build_kernels()
dev = torch.device("cuda")
kg = make_random_kg(**cs.KG)
_, val_q = cs.sample_train_queries(kg)
cfg = mpqe_mod.MPQEConfig(**cs.FLAGSHIP)
gen = torch.Generator(device=dev).manual_seed(0)
model = mpqe_mod.init_mpqe(gen, cfg, device=dev)
with torch.no_grad():
    for lp in model.layers:
        lp.bias.normal_(0.0, 0.1, generator=gen)
mcfg = mpqe_mod.MPQEConfig(**dict(cs.FLAGSHIP, readout="max"))
mmodel = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(6),
                            mcfg, device=dev)
n_q = sum(min(len([q for q in qs if q.neg_samples]), 1000)
          for by_f in val_q.values() for qs in by_f.values())
for label, m, c in (("eval.sparse", model, cfg),
                    ("eval.sparse_max", mmodel, mcfg)):
    walls = []
    for run in range(1 + REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluation.evaluate(m, c, val_q, n_neg=64,
                            encode_fn=cs.SparseEncode())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[1:]))
    print(f"ab {label}: {n_q} queries, walls_s="
          + ",".join(f"{w:.3f}" for w in walls[1:])
          + f" median_s={med:.3f} queries_per_s={n_q / med:.1f}",
          flush=True)
""".replace("REPEATS", str(REPEATS))


def ab(trees) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"nvidia-smi: {smi.strip()}", flush=True)
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", AB_RUN], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("ab eval.")]
        print(f"ab {tree} rc={out.returncode}: " + " | ".join(lines),
              flush=True)
        if out.returncode:
            print(out.stderr[-2000:], flush=True)


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["ab"] and len(argv) > 1:
        ab(argv[1:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
