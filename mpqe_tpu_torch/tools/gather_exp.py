#!/usr/bin/env python3
"""Random-row gather cost by row width and dtype on the card
(counterpart of ``tools/gather_exp.py``): ``table[idx]`` of M random rows
of an ``[N, d]`` table (M = 917,504: the rows a flagship train step
gathers), for d = 32 to 512 in float32 and d = 128 in bfloat16.  Whether
the cost follows the bytes (a narrower row or bf16 helps) or the rows
(only their count matters).

Each iteration gathers, sums the rows in f32 and moves every index by one
plus a term of that sum (0 in practice), so no iteration repeats the
previous one's reads.  Prints one JSON line per case, ``{"case", "ms",
"eff_gbps"}`` (the reference's keys; GB/s of the rows read) with
``device_ms``, ``busy_share`` and ``kernels``.  Runs on the card unless
``--device cpu``.

  python -m mpqe_tpu_torch.tools.gather_exp
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import (device_fields, device_of,
                                               log, timed)

N = 1_000_000
M = 917_504  # rows gathered (the flagship train step's)
CASES = ((128, torch.float32), (128, torch.bfloat16), (256, torch.float32),
         (32, torch.float32), (512, torch.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "gather_exp")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    rng = np.random.default_rng(0)
    idx0 = torch.from_numpy(rng.integers(0, N, M).astype(np.int64)).to(dev)
    # the tables are drawn on the device (the values do not change the
    # time; 10^9 host normals would take longer than the probe)
    gen = torch.Generator(device=dev).manual_seed(0)
    log(f"device={device_fields(dev)} N={N} M={M}")
    for d, dtype in CASES:
        table = torch.randn((N, d), generator=gen, device=dev).to(dtype)

        def loop(n, table=table):
            ix, acc = idx0, torch.zeros((), device=dev)
            for _ in range(n):
                s = torch.sum(table[ix].to(torch.float32))
                ix = (ix + (s * 1e-30).to(torch.int64) + 1) % N
                acc = acc + s
            return acc

        name = f"d{d}_{str(dtype).split('.')[-1]}"
        log(f"{name}...")
        rec = timed(loop, dev)
        gbps = M * d * table.element_size() / (rec["ms"] / 1e3) / 1e9
        print(json.dumps({"case": name, "ms": rec.pop("ms"),
                          "eff_gbps": gbps, **rec}), flush=True)
        del table
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
