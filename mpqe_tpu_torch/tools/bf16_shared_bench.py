#!/usr/bin/env python3
"""The train step's levers, alone and together, at the flagship shape
(counterpart of ``tools/bf16_shared_bench.py``): a bfloat16 model
(bf16 parameters, activations and Adam moments), batch-shared negatives
(``K_SHARED`` candidates for the whole batch instead of ``N_NEG`` per
query), and the fused forward (K1) with its backward by K2 (``pallas``)
or by an autograd recompute of ``encode_dense`` (``xla``).  Both of the
first two cut the entity table's random-row traffic: bf16 the bytes of
each row and of Adam's moments, shared negatives the rows.

One combo is one train step (loss, gradient, ``OptaxAdam`` at lr 0.01)
at B = 131,072, timed by ``utils/profiling.py loop_time`` with the
device ms by kernel beside it.  The reference's ``block``,
``bwd_block`` and ``vmem_limit_mb`` tile the TPU: the port's kernels
take none.  Prints one JSON line per combo with the reference's keys
(``combo``, ``dtype``, ``protocol``, ``encoder``, ``n_negatives``,
``train_step_ms``, ``train_queries_per_s``).  Runs on the card unless
``--device cpu``.

  python -m mpqe_tpu_torch.tools.bf16_shared_bench \\
      [--combos f32,bf16,f32_shared,bf16_shared]
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
B = 131_072
N_NEG = 4
K_SHARED = 512
STEP_ITERS = (5, 55)  # loop_time's (n_small, n_large), the reference's


def loss_fn_for(model, cfg, dev, shared: bool, fused: str):
    """``loss(model)`` of one combo on inputs from
    ``np.random.default_rng(0)``, drawn in the reference's order."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.queries import STRUCTURES

    spec = STRUCTURES[STRUCTURE]
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(dev)

    ne = put(rng.integers(0, N_ENTITIES, (B, spec.n_nodes)).astype(np.int32))
    nm = put(rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32))
    er = put(rng.integers(0, N_RELS, (spec.n_edges,)).astype(np.int32))
    en = put(np.ones((spec.n_edges,), np.float32))
    tgt = put(rng.integers(0, N_ENTITIES, (B,)).astype(np.int32))
    qmask = put(np.ones((B,), np.float32))
    if shared:
        sneg = put(rng.integers(0, N_ENTITIES, (K_SHARED,)).astype(np.int32))
        return lambda m: mpqe_mod.dense_batch_loss_shared_negs(
            m, cfg, STRUCTURE, ne, nm, er, en, tgt, sneg, qmask,
            encoder="fused_fwd" if fused else "dense",
            fused_backward=fused or "xla")
    neg = put(rng.integers(0, N_ENTITIES, (B, N_NEG)).astype(np.int32))
    nmask = put(np.ones((B, N_NEG), np.float32))
    if fused:
        return lambda m: mpqe_mod.dense_batch_loss_kernel_fused_fwd(
            m, cfg, STRUCTURE, ne, nm, er, en, tgt, neg, nmask, qmask,
            backward=fused)
    return lambda m: mpqe_mod.dense_batch_loss(
        m, cfg, STRUCTURE, ne, nm, er, en, tgt, neg, nmask, qmask)


def combo_name(dtype: str, shared: bool, fused: str) -> str:
    return f"{dtype}{'_shared' if shared else ''}" + (
        f"_fused[{fused}]" if fused else "")


def measure(dtype: str, shared: bool, fused: str = "",
            dev: torch.device = None) -> dict:
    """One combo's step time.  ``fused``: '' is the dense encoder; 'xla'
    or 'pallas' the K1 forward with that backward."""
    from mpqe_tpu_torch.bench import _step_loop
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = mpqe_mod.MPQEConfig(
        n_entities=N_ENTITIES, n_modes=N_MODES, n_rels=N_RELS,
        embed_dim=D, n_layers=N_LAYERS, num_bases=NUM_BASES, readout="tgt",
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    # the moments take the parameters' dtype, as optax's
    optimizer = loop_mod.make_optimizer(loop_mod.TrainConfig(lr=0.01),
                                        model.parameters())
    name = combo_name(dtype, shared, fused)
    log(f"[{name}] train step...")
    rec = timed(_step_loop(model, optimizer,
                           loss_fn_for(model, cfg, dev, shared, fused)), dev,
                *STEP_ITERS)
    dt = rec.pop("ms") / 1e3
    row = {
        "combo": name, "dtype": dtype,
        "protocol": ("shared_negatives_variant" if shared
                     else "per_query_negatives"),
        "encoder": f"fused_fwd/{fused}" if fused else "dense",
        "n_negatives": K_SHARED if shared else N_NEG,
        "train_step_ms": dt * 1e3,
        "train_queries_per_s": B / dt,
        **device_fields(dev), **rec,
    }
    print(json.dumps(row), flush=True)
    return row


# combo name -> (dtype, shared, fused backward)
KNOWN_COMBOS = {
    "f32": ("float32", False, ""),
    "bf16": ("bfloat16", False, ""),
    "f32_shared": ("float32", True, ""),
    "bf16_shared": ("bfloat16", True, ""),
    "f32_fused": ("float32", False, "pallas"),
    "bf16_fused": ("bfloat16", False, "pallas"),
    "f32_shared_fused": ("float32", True, "pallas"),
    "bf16_shared_fused": ("bfloat16", True, "pallas"),
    "f32_fused_xlabwd": ("float32", False, "xla"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "bf16_shared_bench")
    ap.add_argument("--combos", default="f32,bf16,f32_shared,bf16_shared")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    combos = [c.strip() for c in args.combos.split(",") if c.strip()]
    bad = [c for c in combos if c not in KNOWN_COMBOS]
    if bad:
        ap.error(f"unknown combo(s) {bad}; known: {list(KNOWN_COMBOS)}")
    dev = device_of(args.device)
    log(f"device={device_fields(dev)} B={B}")
    for c in combos:
        measure(*KNOWN_COMBOS[c], dev=dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
