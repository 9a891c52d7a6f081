#!/usr/bin/env python3
"""The GEMM floor that K1 is held against (counterpart of
``tools/fwd_gemm_floor.py``).  K1's work on a block of rows is the
chain ``relu(X @ W0 + b0) @ W1 + b1`` at ``[B, 384] x [384, 256]`` and
``[B, 256] x [256, 128]`` (bf16 operands, f32 results; B = 131,072),
with the edge, self and norm terms assembled into W beforehand.  This
times the same products through the library, cuBLAS by way of
``ops/dtypes.py dot_f32`` (``torch.mm(..., out_dtype=torch.float32)`` on
two bf16 matrices where this torch has it, else the operands widened to
f32), the yardstick of K1's library column:

  gemm_chain     the two products with the bias adds and the ReLU
  gemm_only      the two products alone
  onehot_build   the packed one-hot block ``[B, 128]`` of two mode
                 columns (iota compare), the layer-0 side work

Prints one JSON line per case, ``{"case", "ms"}`` with ``device_ms``,
``busy_share`` and ``kernels``, then ``{"summary": true, ...}``: the
products' FLOP, their bound on the H100's bf16 tensor-core peak
(``utils/profiling.py``), gemm_only's rate and its share of that peak
(null off the card).  The reference logs these as text.  Runs on the
card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.fwd_gemm_floor
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import (device_fields, device_of,
                                               log, timed)

B = 131_072


def gemm_route(dev: torch.device) -> str:
    from mpqe_tpu_torch.ops import dtypes

    if dev.type == "cuda" and dtypes._mm_out_dtype_available():
        return "torch.mm(bf16, bf16, out_dtype=float32)"
    return "torch.mm(float32, float32) of the bf16 values"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "fwd_gemm_floor")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.ops.dtypes import dot_f32
    from mpqe_tpu_torch.utils import profiling

    rng = np.random.default_rng(0)

    def t(shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev).to(dtype)

    bf = torch.bfloat16
    x0, w0, b0 = t((B, 384), bf), t((384, 256), bf), t((256,))
    w1, b1 = t((256, 128), bf), t((128,))
    modes = torch.from_numpy(rng.integers(0, 4, size=(B, 2)).astype(np.int32)
                             ).to(dev)
    log(f"device={device_fields(dev)} B={B} route={gemm_route(dev)}")

    def chain_loop(n):
        x, acc = x0, torch.zeros((), device=dev)
        with torch.no_grad():
            for _ in range(n):
                y = torch.relu(dot_f32(x, w0) + b0).to(bf)
                z = dot_f32(y, w1) + b1
                x = x + z.to(bf)[:, 0:1] * 1e-8
                acc = acc + z[0, 0]
        return acc

    def gemm_loop(n):
        x, acc = x0, torch.zeros((), device=dev)
        with torch.no_grad():
            for _ in range(n):
                z = dot_f32(dot_f32(x, w0).to(bf), w1)
                x = x + z.to(bf)[:, 0:1] * 1e-8
                acc = acc + z[0, 0]
        return acc

    iota = torch.arange(128, device=dev, dtype=torch.int32)[None, :]

    def onehot_loop(n):
        m, acc = modes, torch.zeros((), device=dev)
        for _ in range(n):
            oh = ((m[:, 0:1] == iota) | (m[:, 1:2] + 8 == iota)).to(bf)
            m = m + oh[:, 0:1].to(torch.int32) * 0
            acc = acc + oh[0, 0]
        return acc

    res = {}
    for name, loop in (("gemm_chain", chain_loop), ("gemm_only", gemm_loop),
                       ("onehot_build", onehot_loop)):
        log(f"{name}...")
        res[name] = timed(loop, dev)
        print(json.dumps({"case": name, **res[name]}), flush=True)
    flops = 2 * B * (384 * 256 + 256 * 128)
    bound_ms = flops / profiling.H100_BF16_FLOPS * 1e3
    dt = res["gemm_only"]["ms"] / 1e3
    on_card = dev.type == "cuda"
    print(json.dumps({
        "summary": True, **device_fields(dev), "gemm_route": gemm_route(dev),
        "flop": flops, "bf16_peak_bound_ms": bound_ms,
        "gemm_only_tflop_per_s": flops / dt / 1e12,
        "gemm_only_fraction_of_bf16_peak": (bound_ms / (dt * 1e3)
                                            if on_card else None)}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
