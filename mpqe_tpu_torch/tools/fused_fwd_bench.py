#!/usr/bin/env python3
"""K1 against the pruned forward on the card, flagship shape
(counterpart of ``tools/fused_fwd_bench.py``): ``encode_dense`` (the
reference's ``xla`` route) and ``encode_dense_fused`` (K1) at B =
131,072 ``3-chain_inter`` queries, each a forward loop of
``mpqe_tpu_torch/bench.py``'s (``_fwd_loop``: its output threaded into
the next iteration's edge norms) timed by ``utils/profiling.py
loop_time``, with edge messages/s counted as the pruned forward executes
them (``executed_edge_messages``).

* ``--variants``: K1's ``fold_bias`` and ``out_bf16`` variants and both
  (``ops/fused_fwd.py fused_tgt_forward``), the sweep behind
  ``mpqe_tpu_torch/bench.py``'s ``fwd_seconds_k1_*`` rows;
* ``--train_bwd``: whole train steps (loss, gradient, ``OptaxAdam``):
  ``dense``, K1 with the autograd recompute (``fused_fwd/xla-bwd``) and
  K1 with K2 (``fused_fwd/pallas-bwd``);
* ``--multi``: K3 (``fused_tgt_forward_multi``) against
  ``encode_dense_multi``, per-query relations (the serving and
  validation encode).

Last, K1 against ``encode_dense`` at B = 1,024 (``max_rel_err``: bf16
operands, so a few 1e-3).  The reference's ``--blocks``,
``--bwd_blocks``, ``--vmem_mb``, ``--multi_vmem_mb``, ``--oh_operand``
and ``--split_gemm`` tile the TPU or choose a TPU operand layout: they
are accepted and ignored (the port's kernels take no block size and
always build the one-hot block outside the kernel), and the routes they
swept run once.  Prints one JSON line per route, ``{"case", "ms",
"msgs_per_s"}`` with ``device_ms``, ``busy_share`` and ``kernels``, and
``{"parity": ...}`` last; the reference logs these as text.  Runs on the
card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.fused_fwd_bench [--variants] [--multi]
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
BATCH = 131_072
FWD_ITERS = (5, 255)  # loop_time's (n_small, n_large): the reference's
STEP_ITERS = (5, 55)
PARITY_BATCH = 1024
IGNORED = ("blocks", "bwd_blocks", "vmem_mb", "multi_vmem_mb", "oh_operand",
           "split_gemm")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "fused_fwd_bench")
    ap.add_argument("--blocks", default="1024,2048,4096",
                    help="ignored: the TPU kernel's block sizes")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--oh_operand", action="store_true",
                    help="ignored: the port always builds the one-hot "
                         "block outside the kernel")
    ap.add_argument("--split_gemm", action="store_true",
                    help="ignored: a TPU operand layout")
    ap.add_argument("--skip_base", action="store_true",
                    help="skip the encode_dense and K1 timings")
    ap.add_argument("--train_bwd", action="store_true",
                    help="time whole train steps: dense, K1 with the "
                         "autograd recompute, K1 with K2")
    ap.add_argument("--bwd_blocks", default="512,1024,2048",
                    help="ignored: the TPU backward's block sizes")
    ap.add_argument("--skip_train_base", action="store_true",
                    help="with --train_bwd: skip the dense and K1 "
                         "recompute steps")
    ap.add_argument("--vmem_mb", type=int, default=24,
                    help="ignored: a TPU scoped-memory limit")
    ap.add_argument("--multi_vmem_mb", type=int, default=100,
                    help="ignored: a TPU scoped-memory limit")
    ap.add_argument("--multi", action="store_true",
                    help="time K3 against encode_dense_multi")
    ap.add_argument("--variants", action="store_true",
                    help="time K1's fold_bias and out_bf16 variants")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.bench import _fwd_loop, _step_loop
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURES
    from mpqe_tpu_torch.train import loop as loop_mod

    spec = STRUCTURES[STRUCTURE]
    cfg = mpqe_mod.MPQEConfig(
        n_entities=N_ENTITIES, n_modes=N_MODES, n_rels=N_RELS,
        embed_dim=D, n_layers=N_LAYERS, num_bases=NUM_BASES, readout="tgt")
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    rng = np.random.default_rng(0)
    B = args.batch

    def put(a):
        return torch.from_numpy(a).to(dev)

    ne = put(rng.integers(0, N_ENTITIES, (B, spec.n_nodes)).astype(np.int32))
    nm = put(rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32))
    er = put(rng.integers(0, N_RELS, (spec.n_edges,)).astype(np.int32))
    en = put(np.ones((spec.n_edges,), np.float32))
    msgs = B * mpqe_mod.executed_edge_messages(cfg, STRUCTURE)
    log(f"device={device_fields(dev)} B={B} (ignored TPU flags: "
        f"{', '.join(IGNORED)})")

    def report(case, loop, iters=FWD_ITERS, count=msgs, unit="msgs_per_s"):
        rec = timed(loop, dev, *iters)
        log(f"{case}: {rec['ms']:.3f} ms")
        print(json.dumps({"case": case, "ms": rec["ms"],
                          unit: count / (rec["ms"] / 1e3),
                          **{k: v for k, v in rec.items() if k != "ms"}}),
              flush=True)

    if not args.skip_base:
        report("xla", _fwd_loop(lambda e: mpqe_mod.encode_dense(
            model, cfg, STRUCTURE, ne, nm, er, e), en, spec.n_edges))
        report("fused", _fwd_loop(lambda e: mpqe_mod.encode_dense_fused(
            model, cfg, STRUCTURE, ne, nm, er, e), en, spec.n_edges))

    if args.variants:
        for fold, ob in ((True, False), (False, True), (True, True)):
            tag = ("fold" if fold else "") + ("+obf16" if ob else "")
            report(f"fused {tag}", _fwd_loop(
                lambda e, fold=fold, ob=ob: ff.fused_tgt_forward(
                    model, cfg, STRUCTURE, ne, nm, er, e, fold_bias=fold,
                    out_bf16=ob), en, spec.n_edges))

    if args.train_bwd:
        tgt = put(rng.integers(0, N_ENTITIES, (B,)).astype(np.int32))
        negatives = put(rng.integers(0, N_ENTITIES, (B, 4)).astype(np.int32))
        neg_mask = put(np.ones((B, 4), np.float32))
        query_mask = put(np.ones((B,), np.float32))
        batch = (ne, nm, er, en, tgt, negatives, neg_mask, query_mask)

        def run_step(tag, loss):
            step_model = mpqe_mod.init_mpqe(
                torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
            optimizer = loop_mod.make_optimizer(
                loop_mod.TrainConfig(lr=0.01), step_model.parameters())
            report(f"step {tag}", _step_loop(
                step_model, optimizer,
                lambda m: loss(m, cfg, STRUCTURE, *batch)), STEP_ITERS, B,
                "queries_per_s")

        if not args.skip_train_base:
            run_step("dense", mpqe_mod.dense_batch_loss)
            run_step("fused_fwd/xla-bwd",
                     mpqe_mod.dense_batch_loss_kernel_fused_fwd)
        run_step("fused_fwd/pallas-bwd",
                 lambda *a: mpqe_mod.dense_batch_loss_kernel_fused_fwd(
                     *a, backward="pallas"))

    if args.multi:
        erq = put(rng.integers(0, N_RELS, (B, spec.n_edges)).astype(np.int32))
        enq = put(np.ones((B, spec.n_edges), np.float32))
        ops = ff.prepare_fused_multi(model, cfg)
        report("multi xla", _fwd_loop(lambda e: mpqe_mod.encode_dense_multi(
            model, cfg, STRUCTURE, ne, nm, erq, e), enq, spec.n_edges))
        report("multi fused", _fwd_loop(
            lambda e: ff.fused_tgt_forward_multi(
                model, cfg, STRUCTURE, ne, nm, erq, e, operands=ops),
            enq, spec.n_edges))

    # K1 against the f32 encoder at a small batch
    n = min(PARITY_BATCH, B)
    with torch.no_grad():
        got = mpqe_mod.encode_dense_fused(model, cfg, STRUCTURE, ne[:n],
                                          nm[:n], er, en)
        want = mpqe_mod.encode_dense(model, cfg, STRUCTURE, ne[:n], nm[:n],
                                     er, en)
    rel = float((got - want).abs().max() / (want.abs().max() + 1e-9))
    log(f"parity (B={n}): max rel err {rel:.2e}")
    print(json.dumps({"parity": True, "batch": n, "max_rel_err": rel,
                      **device_fields(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
