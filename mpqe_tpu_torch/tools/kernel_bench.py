#!/usr/bin/env python3
"""The sparse R-GCN layer's routes on the card at full-KG scale
(counterpart of ``tools/kernel_bench.py``): one layer over a random
typed graph (65,536 nodes, 2^20 edges, 266 relations, d = 128, 16
bases by default) through

  xla       ``ops/rgcn.py rgcn_sparse``: the plain route (basis-first
            einsums, ``index_add_``), the reference's ``xla`` name kept
  fused     ``ops/rgcn_fused.py rgcn_sparse_fused``: K5 (K5a on a basis
            layer) over ``chunk_by_relation``'s relation chunks
  blocked   ``ops/rgcn_blocked.py rgcn_sparse_blocked``: K6a (and K6b in
            its gradient) over ``bucket_edges_blocked``'s node blocks
            (``MPQE_BLOCKED_SHAPES="SB:C,..."`` sweeps block and chunk)

``--paths`` lists them; ``<path>_grad`` times the forward and the
gradient of ``sum(layer(x)^2)`` with respect to x and the layer's
parameters, and ``grad_parity`` prints the blocked gradients' deviation
from the fused route's.  Each is timed by ``utils/profiling.py
loop_time`` (the output threaded into the next input).

The routes are also held to each other: ``fused`` to ``xla`` within
K5's plain gate (max|diff| / max|ref| <= 1e-4; its products are split
TF32, both sums f32), ``fused_grad`` to ``xla_grad`` the same per
gradient, and K6a's messages to their plain version within
``blocked_error_bound`` (``k6a_gate``).  The summary line's bound is
the H100's: the reference's bytes (edge rows gathered, messages written
and read; node rows read, written and aggregated, f32) over 3.35 TB/s
(``utils/profiling.py bound_times``).

Prints one JSON line per path with the reference's keys (``path``,
``ms``, ``edges_per_s``, the shape) and the device ms by kernel, one
``{"agree": ...}`` line per comparison and the ``{"summary": true}``
line; exits 1 if a comparison fails.  ``--chunk`` is K5's and K6's
relation chunk.  Runs on the card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.kernel_bench [--paths xla,fused,blocked]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import (device_fields, device_of,
                                               log, timed)

TOL_PLAIN = 1e-4  # K5 against the plain route: max|diff| / max|ref|


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def layer_grads(layer_fn, layer, x):
    """``{"dx": ..., "d<param>": ...}`` of ``sum(layer_fn(x)^2) * 1e-6``."""
    xx = x.detach().requires_grad_(True)
    names, params = zip(*layer.named_parameters())
    out = layer_fn(xx)
    grads = torch.autograd.grad(torch.sum(out * out) * 1e-6,
                                [xx, *params], allow_unused=True)
    return {"dx": grads[0], **{f"d{n}": g for n, g in zip(names, grads[1:])
                               if g is not None}}


def bench_config(n_nodes, n_e, n_rels, d, num_bases, chunk, paths,
                 dev) -> bool:
    """Times ``paths`` and prints the records; True if every comparison
    holds."""
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops.edge_store import build_edge_store
    from mpqe_tpu_torch.utils import profiling

    rng = np.random.default_rng(0)
    src = rng.integers(0, n_nodes, n_e).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_e).astype(np.int32)
    rel = rng.integers(0, n_rels, n_e).astype(np.int32)
    st = build_edge_store(src, dst, rel, n_nodes, n_rels)
    layer = rgcn_ops.init_rgcn_layer(
        torch.Generator(device=dev).manual_seed(0), d, d, n_rels, num_bases,
        device=dev)
    x = torch.from_numpy(rng.normal(size=(n_nodes, d)).astype(np.float32)
                         ).to(dev)
    ch = rf.chunk_by_relation(st, chunk=chunk)
    ch_dev = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                  else v) for k, v in ch.items()}
    e_pad = int(ch["src"].shape[0])
    store_t = [torch.from_numpy(a).to(dev)
               for a in (st.src, st.dst, st.rel, st.norm)]
    shape = {"n_nodes": n_nodes, "n_edges": n_e, "e_pad": e_pad,
             "n_rels": n_rels, "d": d, "num_bases": num_bases,
             "chunk": chunk}
    results, ok = {}, True

    def xla_layer(xx):
        return rgcn_ops.rgcn_sparse(xx, layer, *store_t, n_rels)

    def fused_layer(xx):
        return rf.rgcn_sparse_fused(xx, layer, ch_dev, n_rels)

    def run(name, layer_fn, grad=False):
        def loop(n):
            xx, acc = x, torch.zeros((), device=dev)
            for _ in range(n):
                if grad:
                    dx = layer_grads(layer_fn, layer, xx)["dx"]
                    xx, acc = xx + dx * 1e-30, acc + dx[0, 0]
                else:
                    with torch.no_grad():
                        out = layer_fn(xx)
                    xx, acc = xx + out * 1e-30, acc + out[0, 0]
            return acc

        log(f"{name}{' (fwd+bwd)' if grad else ''}...")
        rec = timed(loop, dev)
        dt = rec.pop("ms") / 1e3
        print(json.dumps({"path": name, "ms": dt * 1e3,
                          "edges_per_s": n_e / dt, **shape,
                          **({"grad": True} if grad else {}),
                          **device_fields(dev), **rec}), flush=True)
        results[name] = dt

    def agree(name, vs, **fig):
        print(json.dumps({"agree": name, "vs": vs, **fig}), flush=True)
        return fig["ok"]

    if "xla" in paths:
        run("rgcn_sparse_xla", xla_layer)
    if "xla_grad" in paths:
        run("rgcn_sparse_xla_grad", xla_layer, grad=True)
    if "fused" in paths:
        run("rgcn_sparse_fused", fused_layer)
        with torch.no_grad():
            e = _rel_err(fused_layer(x), xla_layer(x))
        ok &= agree("rgcn_sparse_fused", "rgcn_sparse_xla", max_rel_err=e,
                    tol=TOL_PLAIN, ok=e <= TOL_PLAIN)
    if "fused_grad" in paths:
        run("rgcn_sparse_fused_grad", fused_layer, grad=True)
        gf = layer_grads(fused_layer, layer, x)
        gx = layer_grads(xla_layer, layer, x)
        errs = {k: _rel_err(gf[k], gx[k]) for k in gx}
        ok &= agree("rgcn_sparse_fused_grad", "rgcn_sparse_xla_grad",
                    max_rel_err=errs, tol=TOL_PLAIN,
                    ok=max(errs.values()) <= TOL_PLAIN)
    if num_bases is not None and any("blocked" in p or p == "grad_parity"
                                     for p in paths):
        default_shapes = f"{rb.DEFAULT_NODE_BLOCK}:{rb.DEFAULT_CHUNK}"
        shapes = [tuple(int(v) for v in s.split(":"))
                  for s in os.environ.get(
                      "MPQE_BLOCKED_SHAPES", default_shapes).split(",")]
        bk_first = None
        for sb, c in shapes:
            bk = rb.layouts_on(rb.bucket_edges_blocked(st, node_block=sb,
                                                       chunk=c), dev)
            bk_first = bk_first or bk
            if "blocked" in paths:
                run(f"rgcn_sparse_blocked_bf16_sb{sb}_c{c}",
                    lambda xx, _bk=bk: rb.rgcn_sparse_blocked(
                        xx, layer, _bk, n_rels))
                ok &= agree(f"K6a_sb{sb}_c{c}", "plain K6a",
                            **k6a_agreement(rb, x, layer, bk[0], n_rels))
        if "blocked" in paths:
            results["rgcn_sparse_blocked_bf16"] = min(
                v for k, v in results.items() if "blocked" in k)
        if "blocked_grad" in paths:
            run("rgcn_sparse_blocked_bf16_grad",
                lambda xx: rb.rgcn_sparse_blocked(xx, layer, bk_first,
                                                  n_rels), grad=True)
        if "grad_parity" in paths:
            # the blocked backward against the fused f32 route's (both
            # without an [E, Bb, d] tensor), at bf16's tolerance: printed
            gb = layer_grads(lambda xx: rb.rgcn_sparse_blocked(
                xx, layer, bk_first, n_rels), layer, x)
            gf = layer_grads(fused_layer, layer, x)
            rec = {"grad_parity": True}
            for k in gf:
                rec[f"{k}_max_rel_dev"] = _rel_err(gb[k], gf[k])
            print(json.dumps(rec), flush=True)

    if "rgcn_sparse_xla" in results and "rgcn_sparse_fused" in results:
        # the reference's bytes: gather E rows, write and read the
        # messages; read x (self-loop), write the output, the aggregate
        bytes_min = e_pad * d * 4 * 3 + n_nodes * d * 4 * 3
        sol_ms = profiling.bound_times((bytes_min, 0.0, 0.0))[0]
        fused_ms = results["rgcn_sparse_fused"] * 1e3
        print(json.dumps({
            "summary": True,
            "speedup_fused_over_xla": (results["rgcn_sparse_xla"]
                                       / results["rgcn_sparse_fused"]),
            "fused_ms": fused_ms,
            "xla_ms": results["rgcn_sparse_xla"] * 1e3,
            "fused_roofline_fraction": (sol_ms / fused_ms
                                        if dev.type == "cuda" else None),
            "roofline_ms": sol_ms,
            "roofline_model": "H100 3.35 TB/s, the reference's bytes",
            **device_fields(dev)}), flush=True)
    return ok


def k6a_agreement(rb, x, layer, lay, n_rels) -> dict:
    """K6a's messages against the plain version under
    ``blocked_error_bound`` (``k6a_gate``)."""
    n = x.shape[0]
    basis, coeff = layer.basis.detach(), layer.coeff.detach()
    with torch.no_grad():
        got = rb.messages_blocked(x, basis, coeff, lay, n_rels)
        msg = rb._edge_messages(x, basis, coeff, lay, n_rels)
        plain = rb._dst_sum(msg, lay, n)
        bound = rb.blocked_error_bound(x, basis, coeff, lay, n_rels, n, msg)
    return rb.k6a_gate(got, plain, bound)


def main(argv=None) -> int:
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "kernel_bench")
    ap.add_argument("--n_nodes", type=int, default=65_536)
    ap.add_argument("--n_edges", type=int, default=1_048_576)
    ap.add_argument("--n_rels", type=int, default=266)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--num_bases", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=rf.DEFAULT_CHUNK)
    ap.add_argument("--paths", default="xla,fused")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    ok = bench_config(
        args.n_nodes, args.n_edges, args.n_rels, args.d,
        None if args.num_bases <= 0 else args.num_bases,
        args.chunk, args.paths.split(","), dev)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
