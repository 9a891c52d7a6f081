#!/usr/bin/env python3
"""K2's gradients leaf by leaf (counterpart of ``tools/fused_bwd_diag.py``):
K2 (``ops/fused_fwd.py fused_tgt_backward``: bf16 operands, the
kernel on the card) and its plain version with every bf16 rounding
dropped (``fused_tgt_backward_reference(f32_wire=True)``: the reverse
sweep's structure alone) against autograd of the f32 ``encode_dense``,
per parameter, in max|diff| / max|ref| and mean|diff| / mean|ref|; and K2
against its plain version with the bf16 wire.  If the f32 wire matches
autograd, the reverse sweep is right and what K2 differs by is operand
rounding.

The oracle runs twice: TF32 off (the port's setting, "HIGHEST") and
TF32 allowed ("default"); their difference is the oracle's own precision
envelope, printed first.  A leaf is flagged ``BAD(mean)`` when its mean
form exceeds the port's limit, not the reference's TPU bar of 3e-2: for
K2 against the f32 oracle the depth tolerance
``ops/fused_fwd.py F32_GRAD_MEAN_BY_DEPTH`` (bf16 products against f32),
for the f32 wire against it and for K2 against its plain version
``PARAM_GRAD_MEAN_BY_DEPTH``.  ``edge_norm``'s cotangent is a sum over
the batch with heavy cancellation: printed, never flagged.

Model: 2,000 entities, 12 relations, d = 128, 3 layers, 8 bases
(weights from seed 7); inputs from ``np.random.default_rng(0)``.  The
reference's ``--bwd_block`` tiles the TPU backward: accepted and
ignored.  Prints the reference's text lines, then one JSON line
``{"ok", "bad", "depth", ...}``; exits 1 if a leaf is flagged.  Runs on
the card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.fused_bwd_diag [--batch 1024]
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import device_fields, device_of, log


def walk(a, b, path=""):
    """``[(path, max form, mean form)]`` of every array leaf of ``a``
    against ``b`` (nested dicts, lists and tuples), the reference's."""
    rows = []
    if isinstance(a, dict):
        for k in sorted(a):
            rows += walk(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            rows += walk(x, y, f"{path}[{i}]")
    else:
        x, y = _f32(a), _f32(b)
        if x.size == 0:
            return rows
        s = np.max(np.abs(y)) + 1e-9
        mx = float(np.max(np.abs(x - y)) / s)
        mean = float(np.mean(np.abs(x - y)) / (np.mean(np.abs(y)) + 1e-9))
        rows.append((path, mx, mean))
    return rows


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


@contextlib.contextmanager
def tf32(allowed: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "fused_bwd_diag")
    ap.add_argument("--bwd_block", type=int, default=512,
                    help="ignored: the TPU backward's block size")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--structure", default="3-chain_inter")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURES

    rng = np.random.default_rng(0)
    spec = STRUCTURES[args.structure]
    cfg = mpqe_mod.MPQEConfig(
        n_entities=2000, n_modes=4, n_rels=12, embed_dim=128,
        n_layers=3, num_bases=8, readout="tgt")
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(7),
                               cfg, device=dev)
    depth = mpqe_mod.num_steps(cfg, args.structure)
    B = args.batch

    def put(a):
        return torch.from_numpy(a).to(dev)

    ne = put(rng.integers(0, 2000, (B, spec.n_nodes)).astype(np.int32))
    nm = put(rng.integers(0, 4, (B, spec.n_nodes)).astype(np.int32))
    er = put(rng.integers(0, 12, (spec.n_edges,)).astype(np.int32))
    en = put(rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(np.float32))
    g = put(rng.normal(size=(B, 128)).astype(np.float32))
    names = [n for n, _ in model.named_parameters()]
    log(f"device={device_fields(dev)} structure={args.structure} B={B} "
        f"depth={depth} (--bwd_block ignored)")

    def oracle(allow_tf32: bool):
        e = en.clone().requires_grad_(True)
        with tf32(allow_tf32):
            q = mpqe_mod.encode_dense(model, cfg, args.structure, ne, nm, er,
                                      e)
            grads = torch.autograd.grad(q, [*model.parameters(), e], g,
                                        allow_unused=True)
        return ({n: (gr if gr is not None else torch.zeros_like(p))
                 for (n, p), gr in zip(model.named_parameters(), grads)},
                grads[-1])

    dp_x, den_x = oracle(True)
    dp_h, den_h = oracle(False)
    print("--- oracle self-envelope (HIGHEST vs default)")
    for path, mx, mean in walk(dp_h, dp_x) + walk(den_h, den_x, "edge_norm"):
        print(f"  {path}: max {mx:.4e}  mean {mean:.4e}", flush=True)

    args_k2 = (model, cfg, args.structure, ne, nm, er, en, None, g)
    k2 = ff.fused_tgt_backward(*args_k2)
    plain = ff.fused_tgt_backward_reference(*args_k2)
    f32w = ff.fused_tgt_backward_reference(*args_k2, f32_wire=True)
    sections = (
        (f"--- f32_wire=False bwd_block={args.bwd_block}", k2, (dp_h, den_h),
         ff.F32_GRAD_MEAN_BY_DEPTH[depth]),
        (f"--- f32_wire=True bwd_block={args.bwd_block}", f32w,
         (dp_h, den_h), ff.PARAM_GRAD_MEAN_BY_DEPTH[depth]),
        ("--- K2 vs its plain version (bf16 wire)", k2, plain[:2],
         ff.PARAM_GRAD_MEAN_BY_DEPTH[depth]))
    worst, bad = {}, 0
    for title, (dp, den, _), (want_p, want_den), limit in sections:
        print(title + f" (flag: mean > {limit:g})")
        rows = walk({n: dp[n] for n in names}, want_p)
        worst[title] = max(mean for _, _, mean in rows)
        for path, mx, mean in rows:
            flag = " <-- BAD(mean)" if mean > limit else ""
            bad += bool(flag)
            print(f"  {path}: max {mx:.4e}  mean {mean:.4e}{flag}",
                  flush=True)
        for path, mx, mean in walk(den, want_den, "edge_norm"):
            print(f"  {path}: max {mx:.4e}  mean {mean:.4e} (not flagged)",
                  flush=True)
    print(json.dumps({
        "ok": bad == 0, "bad": bad, "structure": args.structure,
        "depth": depth, "batch": B,
        "k2_vs_f32_mean_max": worst[sections[0][0]],
        "k2_vs_f32_tol": sections[0][3],
        "f32_wire_vs_f32_mean_max": worst[sections[1][0]],
        "k2_vs_plain_mean_max": worst[sections[2][0]],
        "plain_tol": ff.PARAM_GRAD_MEAN_BY_DEPTH[depth],
        **device_fields(dev)}), flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
