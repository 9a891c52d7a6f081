#!/usr/bin/env python3
"""Every hand-written kernel of the port against its oracles, at the
reference chip check's shapes (counterpart of ``tools/tpu_smoke.py``,
named for what it is on this card).  On the card each wrapper launches
its CUDA kernel; under ``--device cpu`` each runs its plain PyTorch
version, so the run checks the plain versions against the same oracles.

Each case is held to the reference's oracle at the reference's
tolerance and, where the port holds the kernel to a tighter gate, to
that gate against the plain version as well:

* K4a / K4b (``segment_sum_kernel`` / ``segment_max_kernel``, E =
  1,000 rows, 64 segments): a numpy oracle (rtol = atol = 2e-3); K4a
  within 1e-4 of its plain version, K4b equal to it;
* K5 (``rgcn_sparse_fused``, 512 nodes, 4,096 edges, 16 relations, d =
  128, 8 bases): ``rgcn_sparse`` (2e-3; K5's plain gate, max|diff| /
  max|ref| <= 1e-4);
* K6a / K6b (``rgcn_sparse_blocked``): ``rgcn_sparse`` and the blocked
  gradients against K5's route, normalized (the reference's bf16
  tolerance 5e-2); K6a's messages within ``blocked_error_bound`` of its
  plain version (``k6a_gate``) and, on the card, K6b under ``k6b_gate``;
* K7 (``sddmm_kernel``, 2,048 edges): an f64 oracle (2e-3), equal to
  its plain version;
* K1 (``encode_dense_fused``, 2,000 entities, 12 relations, d = 128, 3
  layers, 8 bases, B = 1,024 ``3-chain_inter`` queries): ``chain_gate``
  against its plain version, and the f32 ``encode_dense`` within 3e-2
  (bf16 operands);
* K2 (``encode_dense_fused(backward="pallas")``): the reference's
  precision envelope (per parameter, mean|K2 - oracle| / mean|oracle|
  within 1.5 x the oracle's own TF32-vs-f32 deviation or the depth
  tolerance ``F32_GRAD_MEAN_BY_DEPTH``, whichever is larger)
  and ``PARAM_GRAD_MEAN_BY_DEPTH`` against its plain version;
* K3 (``fused_tgt_forward_multi``, per-query relations): ``multi_gate``
  against its plain version, and ``encode_dense_multi`` within 3e-2.

Prints one line per check (``name: OK`` or ``MISMATCH`` with its
figures), then ``{"ok", "checks", "failed", "backend", ...}``; exits 1
on any mismatch.  Runs on the card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.kernel_smoke
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import device_fields, device_of, log

RTOL = ATOL = 2e-3  # the reference's oracle tolerance
TOL_BF16 = 5e-2  # the reference's, for the blocked bf16 route
TOL_PLAIN = 1e-4  # K4a / K5 against the plain version, max|diff| / max|ref|
TOL_F32 = 3e-2  # K1 / K3 (bf16 operands) against the f32 encoder
SEG = dict(rows=1000, d=128, segments=64)
GRAPH = dict(n_nodes=512, n_edges=4096, n_rels=16, d=128, bases=8)
SDDMM_EDGES = 2048
MODEL = dict(n_entities=2000, n_modes=4, n_rels=12, embed_dim=128,
             n_layers=3, num_bases=8, readout="tgt")
BQ = 1024
STRUCTURE = "3-chain_inter"


def segment_sum_np(data: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + data.shape[1:], dtype=data.dtype)
    for i, s in enumerate(seg):
        if 0 <= s < n:
            out[s] += data[i]
    return out


def segment_max_np(data: np.ndarray, seg: np.ndarray, n: int,
                   empty_value: float = 0.0) -> np.ndarray:
    out = np.full((n,) + data.shape[1:], -np.inf, dtype=np.float64)
    for i, s in enumerate(seg):
        if 0 <= s < n:
            out[s] = np.maximum(out[s], data[i])
    out[np.isneginf(out)] = empty_value
    return out.astype(data.dtype)


class Checks:
    def __init__(self):
        self.names, self.failed = [], []

    def record(self, name: str, ok: bool, figures: str) -> bool:
        self.names.append(name)
        if not ok:
            self.failed.append(name)
        print(f"{name}: {'OK' if ok else 'MISMATCH'} ({figures})",
              flush=True)
        return ok

    def close(self, name, got, want, rtol=RTOL, atol=ATOL) -> bool:
        """np.allclose, the reference's check."""
        got, want = _np(got), _np(want)
        ok = bool(np.allclose(got, want, rtol=rtol, atol=atol))
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
        return self.record(name, ok, f"max abs err {err:.2e}")

    def rel(self, name, got, want, tol) -> bool:
        e = _rel_err(got, want)
        return self.record(name, e <= tol,
                           f"max|diff|/max|ref| {e:.2e} <= {tol:g}")

    def gate(self, name, gate: dict) -> bool:
        figs = " ".join(f"{k}={v:.3e}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in gate.items() if k != "ok")
        return self.record(name, bool(gate["ok"]), figs)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, np.float64)


def _rel_err(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def check_segments(c: Checks, rng, dev) -> None:
    from mpqe_tpu_torch.ops import segment_kernels as sk

    E, d, S = SEG["rows"], SEG["d"], SEG["segments"]
    data = rng.normal(size=(E, d)).astype(np.float32)
    ids = rng.integers(0, S, E).astype(np.int32)
    dt, it = torch.from_numpy(data).to(dev), torch.from_numpy(ids).to(dev)
    got = sk.segment_sum_kernel(dt, it, S)
    c.close("segment_sum (K4a)", got, segment_sum_np(data, ids, S))
    c.rel("segment_sum (K4a) vs plain", got,
          sk.segment_sum_reference(dt, it, S), TOL_PLAIN)
    got = sk.segment_max_kernel(dt, it, S)
    c.close("segment_max (K4b)", got,
            segment_max_np(data, ids, S, empty_value=sk.NEG_INF))
    c.record("segment_max (K4b) vs plain",
             bool(torch.equal(got, sk.segment_max_reference(dt, it, S))),
             "equal")


def check_sparse(c: Checks, rng, dev) -> None:
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops.edge_store import build_edge_store
    from mpqe_tpu_torch.tools.kernel_bench import k6a_agreement, layer_grads

    n, E, R, d = (GRAPH[k] for k in ("n_nodes", "n_edges", "n_rels", "d"))
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    rel = rng.integers(0, R, E).astype(np.int32)
    st = build_edge_store(src, dst, rel, n, R)
    layer = rgcn_ops.init_rgcn_layer(
        torch.Generator(device=dev).manual_seed(0), d, d, R, GRAPH["bases"],
        device=dev)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    store_t = [torch.from_numpy(a).to(dev)
               for a in (st.src, st.dst, st.rel, st.norm)]
    ch = rf.chunk_by_relation(st, chunk=128)

    def oracle_layer(xx):
        return rgcn_ops.rgcn_sparse(xx, layer, *store_t, R)

    def fused_layer(xx):
        return rf.rgcn_sparse_fused(xx, layer, ch, R)

    with torch.no_grad():
        want = oracle_layer(x)
        got = fused_layer(x)
    c.close("rgcn_sparse_fused (K5)", got, want)
    c.rel("rgcn_sparse_fused (K5) plain gate", got, want, TOL_PLAIN)

    bk = rb.layouts_on(rb.bucket_edges_blocked(st, node_block=128,
                                               chunk=128), dev)

    def blocked_layer(xx):
        return rb.rgcn_sparse_blocked(xx, layer, bk, R)

    with torch.no_grad():
        got = blocked_layer(x)
    c.close("rgcn_sparse_blocked_bf16 (K6a)", got, want, TOL_BF16, TOL_BF16)
    c.gate("rgcn_sparse_blocked (K6a) bound",
           k6a_agreement(rb, x, layer, bk[0], R))
    gb = layer_grads(blocked_layer, layer, x)
    gf = layer_grads(fused_layer, layer, x)
    for k in ("dx", "dbasis", "dcoeff"):
        s = float(gf[k].abs().max()) + 1e-12
        c.close(f"blocked_grad_{k} (K6a/K6b)", gb[k] / s, gf[k] / s,
                TOL_BF16, TOL_BF16)
    if dev.type == "cuda":
        lay = bk[0]
        basis, coeff = layer.basis.detach(), layer.coeff.detach()
        g = torch.randn((n, d), generator=torch.Generator(device=dev)
                        .manual_seed(1), device=dev)
        with torch.no_grad():
            c.gate("grad_blocked (K6b) gate", rb.k6b_gate(
                rb.grad_blocked_parts(x, g, basis, coeff, lay, R),
                rb.grad_blocked_reference_parts(x, g, basis, coeff, lay, R),
                rb.grad_s_bound(x, g, basis, lay), lay["rel"], R))


def check_sddmm(c: Checks, rng, dev) -> None:
    from mpqe_tpu_torch.ops import sddmm as sd

    n, d = GRAPH["n_nodes"], GRAPH["d"]
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    e_src = rng.integers(0, n, SDDMM_EDGES).astype(np.int32)
    e_dst = rng.integers(0, n, SDDMM_EDGES).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (x, y, e_src, e_dst)]
    got = sd.sddmm_kernel(*args)
    want = np.einsum("ed,ed->e", x.astype(np.float64)[e_src],
                     y.astype(np.float64)[e_dst])
    c.close("sddmm (K7)", got, want)
    c.record("sddmm (K7) vs plain",
             bool(torch.equal(got, sd.sddmm_reference(*args))), "equal")


def check_tgt(c: Checks, rng, dev) -> None:
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURES
    from mpqe_tpu_torch.tools.fused_bwd_diag import tf32

    spec = STRUCTURES[STRUCTURE]
    cfg = mpqe_mod.MPQEConfig(**MODEL)
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(7),
                               cfg, device=dev)
    depth = mpqe_mod.num_steps(cfg, STRUCTURE)
    nr = MODEL["n_rels"]

    def put(a):
        return torch.from_numpy(a).to(dev)

    ne = put(rng.integers(0, MODEL["n_entities"], (BQ, spec.n_nodes)
                          ).astype(np.int32))
    nm = put(rng.integers(0, 4, (BQ, spec.n_nodes)).astype(np.int32))
    er = put(rng.integers(0, nr, (spec.n_edges,)).astype(np.int32))
    en = put(rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(np.float32))
    args = (model, cfg, STRUCTURE, ne, nm, er)
    with torch.no_grad():
        got = mpqe_mod.encode_dense_fused(*args, en)
        f32 = mpqe_mod.encode_dense(*args, en)
        plain = ff.fused_tgt_forward_reference(*args, en)
    c.gate("fused_whole_forward (K1) chain_gate",
           ff.chain_gate(got, plain, depth))
    c.rel("fused_whole_forward (K1) vs f32", got, f32, TOL_F32)

    g_ct = put(rng.normal(size=(BQ, MODEL["embed_dim"])).astype(np.float32))
    names = [n for n, _ in model.named_parameters()]

    def vjp(fn):
        e = en.clone().requires_grad_(True)
        q = fn(e)
        grads = torch.autograd.grad(q, [*model.parameters(), e], g_ct,
                                    allow_unused=True)
        return [gr if gr is not None else torch.zeros_like(p) for gr, p in
                zip(grads, [*model.parameters(), e])]

    k2 = vjp(lambda e: mpqe_mod.encode_dense_fused(*args, e,
                                                   backward="pallas"))
    with tf32(True):
        dflt = vjp(lambda e: mpqe_mod.encode_dense(*args, e))
    with tf32(False):
        high = vjp(lambda e: mpqe_mod.encode_dense(*args, e))
    worst = 0.0
    for name, a, b, h in zip(names + ["edge_norm"], k2, dflt, high):
        if a.numel() == 0:
            continue
        s = float(b.abs().mean()) + 1e-9
        err = float((a - b).abs().mean()) / s
        env = max(1.5 * float((h - b).abs().mean()) / s,
                  ff.F32_GRAD_MEAN_BY_DEPTH[depth])
        log(f"  bwd leaf {name} shape={tuple(a.shape)}: mean_err {err:.4f} "
            f"gate {env:.4f} ratio {err / env:.2f}")
        # edge_norm's cotangent sums over the batch with heavy
        # cancellation: printed, not gated (as chip_smoke.py)
        if name != "edge_norm":
            worst = max(worst, err / env)
    c.record("fused_pallas_backward_vs_precision_envelope (K2)", worst <= 1,
             f"worst mean_err / gate {worst:.3f} <= 1")
    dp_k2 = ff.fused_tgt_backward(*args, en, None, g_ct)[0]
    dp_plain = ff.fused_tgt_backward_reference(*args, en, None, g_ct)[0]
    e = ff.param_grad_mean_err({n: dp_k2[n] for n in names}, dp_plain)
    tol = ff.PARAM_GRAD_MEAN_BY_DEPTH[depth]
    c.record("fused_tgt_backward (K2) vs plain", e <= tol,
             f"mean form {e:.3e} <= {tol:g}")

    erq = put(rng.integers(0, nr, (BQ, spec.n_edges)).astype(np.int32))
    enq = put(rng.uniform(0.5, 1.5, (BQ, spec.n_edges)).astype(np.float32))
    ops = ff.prepare_fused_multi(model, cfg)
    margs = (ne, nm, erq, enq)
    with torch.no_grad():
        got, acts = ff.fused_tgt_forward_multi_layers(
            model, cfg, STRUCTURE, *margs, operands=ops)
        plain = ff.fused_tgt_forward_multi_reference(
            model, cfg, STRUCTURE, *margs, operands=ops)
        f32 = mpqe_mod.encode_dense_multi(model, cfg, STRUCTURE, *margs)
        c.gate("fused_multi_forward (K3) multi_gate", ff.multi_gate(
            cfg, STRUCTURE, ops, margs, got, acts, want=plain))
    c.rel("fused_multi_forward (K3) vs f32", got, f32, TOL_F32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "kernel_smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(f"backend: {dev.type} ({device_fields(dev)['device_name']})",
          flush=True)
    rng = np.random.default_rng(0)
    c = Checks()
    for check in (check_segments, check_sparse, check_sddmm, check_tgt):
        check(c, rng, dev)
    print(json.dumps({"ok": not c.failed, "checks": len(c.names),
                      "failed": c.failed, **device_fields(dev)}), flush=True)
    return 1 if c.failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
