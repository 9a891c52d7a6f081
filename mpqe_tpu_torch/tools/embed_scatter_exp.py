#!/usr/bin/env python3
"""The entity-table gradient's scatter, four ways, on the card
(counterpart of ``tools/embed_scatter_exp.py``): the backward of a
gather-heavy toy loss ``sum_j <t[idx_j]^2, c_j>`` over a ``[N, D]``
table and ``B x COLS`` random ids (2 anchors, the target and 4
negatives a query, as in the flagship step):

  multi     one ``embedding_lookup`` per column: COLS full-table
            gradients, added
  fused     one lookup of all ids, one scatter (``scatter_add_dense``)
  sorted    the same, rows added in index order (``scatter_add_sorted``)
  dedup     sorted, each index's rows summed first, one row added per
            distinct index (``scatter_add_dedup``)

The scatters are the port's own (``ops/embed.py SCATTERS``, reached
through ``embedding_lookup(grad_scatter=)``).  Each variant's gradient
is also held to the first's: they differ only in the order of their
sums, and ``index_add_`` adds with atomics on the card, so they agree
to ``GRAD_TOL`` in mean|diff| / mean|ref|, not bit for bit.

Prints one JSON line per variant, ``{"variant", "ms"}`` (the reference's
keys) with ``grad_mean_err`` (against ``multi``), ``device_ms``,
``busy_share`` and ``kernels``; exits 1 if a gradient disagrees.  Runs
on the card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.embed_scatter_exp
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

# the reference's three scatters, under its names: the port's own
from mpqe_tpu_torch.ops.embed import scatter_add_dedup as scatter_dedup
from mpqe_tpu_torch.ops.embed import scatter_add_dense as scatter_plain
from mpqe_tpu_torch.ops.embed import scatter_add_sorted as scatter_sorted
from mpqe_tpu_torch.tools.probe_common import (device_fields, device_of,
                                               log, timed)

__all__ = ["scatter_plain", "scatter_sorted", "scatter_dedup", "make_loss",
           "main"]

N = 1_000_000
D = 128
B = 131_072
COLS = 7  # 2 anchors + 1 target + 4 negatives
GRAD_TOL = 1e-4  # mean|diff| / mean|ref| between two variants' gradients
VARIANTS = ("multi", "fused", "sorted", "dedup")


def make_loss(mode: str):
    """``loss(t, idx [B, COLS], c [B, COLS, D])`` of the variant."""
    from mpqe_tpu_torch.ops.embed import embedding_lookup

    if mode == "multi":
        def loss(t, idx, c):
            acc = 0.0
            for j in range(idx.shape[1]):
                acc = acc + torch.sum(
                    torch.square(embedding_lookup(t, idx[:, j])) * c[:, j])
            return acc
        return loss
    scatter = {"fused": "dense", "sorted": "sorted", "dedup": "dedup"}[mode]

    def loss(t, idx, c):
        rows = embedding_lookup(t, idx.reshape(-1), scatter)
        return torch.sum(torch.square(rows) * c.reshape(-1, c.shape[-1]))
    return loss


def grad_of(loss, table, idx, c) -> torch.Tensor:
    t = table.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(t, idx, c), [t])
    return g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "embed_scatter_exp")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, N, (B, COLS)).astype(np.int32)
                           ).to(dev)
    # the table and the cotangent's weights are drawn on the device (their
    # values do not change the time)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((N, D), generator=gen, device=dev)
    c = torch.randn((B, COLS, D), generator=gen, device=dev)
    log(f"device={device_fields(dev)} N={N} B={B} COLS={COLS}")
    ok, ref = True, None
    for mode in VARIANTS:
        loss = make_loss(mode)
        g = grad_of(loss, table, idx, c)
        if ref is None:
            ref = g
        err = float((g - ref).abs().mean() / ref.abs().mean())
        ok &= err <= GRAD_TOL
        del g

        def loop(n, loss=loss):
            t, acc = table, torch.zeros((), device=dev)
            for _ in range(n):
                g = grad_of(loss, t, idx, c)
                t = t + g * 1e-30
                acc = acc + g[0, 0]
            return acc

        log(f"{mode}...")
        print(json.dumps({"variant": mode, **timed(loop, dev),
                          "grad_mean_err": err, "grad_tol": GRAD_TOL}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
