#!/usr/bin/env python3
"""Measurements behind the K5/K6 width and K8 findings in PERF.md.

``check [--k8]`` (one CUDA card, ~2 minutes)
    A first call after a kernel change: build every library (ptxas's
    report printed), then (unless ``--k8``) ``chip_smoke.py``'s wide K5
    and K6 cases (``wide_rgcn_fused``, ``wide_rgcn_blocked``: gates,
    controls, repeats, times) and K8 on the general graph at P = 2 and 3 and on one template
    batch at P = 4 against its plain version and the f32 oracles under
    ``ring_gate``, its controls and its launch count.
``same_bits PARENT`` (one CUDA card)
    The parent checkout PARENT's K5 and K6 libraries (built from its
    ``csrc``) against this checkout's on the same inputs at the flagship
    width (d = 128, 16 bases): K5a and K5b on the 7 template batches at
    B = 512 and the general graph, K6a (both layouts) and K6b on the 7
    template batches at B = 512: every output bit-equal.
``ab PARENT [ROUNDS]`` (one CUDA card)
    The parent checkout PARENT's K8 (its ``ops/ring.py`` loaded as a
    module of its own, its library built from its ``csrc``) and this
    checkout's, in turns in one process (parent, change, change, parent;
    ROUNDS rounds, 3 unless given): each side's wrapper ms (CUDA events
    around the call, L2 flushed, ``chip_smoke.time_ms``) and host ms
    (host clock around the enqueue after a synchronize, median of 20),
    summed over the 7 template batches at B = 512 on 4 parts; then the
    medians per side.
``copies`` (one CUDA card)
    The ring's slot copies on the general graph at P = 2, 3, 4, 8 timed
    alone (no kernel beside them: CUDA events around each call's P - 1
    hops of slice copies on one stream, mean of 20), against the copy
    stream's busy ms inside K8's call (``chip_smoke.ring_device_ms``), where
    each copy runs beside a hop's kernels.
``host`` (one CUDA card)
    K8's wrapper on the 7 template batches at B = 512 on 4 parts: the
    call's host ms (host clock, enqueue only, median of 30 calls after a
    synchronize) against its device ms, and torch.profiler's CPU self
    time by operation over 10 calls of each, the largest first.

Usage: python3 mpqe_tpu_torch/tools/k8_probe.py check [--k8]
       python3 mpqe_tpu_torch/tools/k8_probe.py same_bits runs/parent
       python3 mpqe_tpu_torch/tools/k8_probe.py ab runs/parent
       python3 mpqe_tpu_torch/tools/k8_probe.py copies
       python3 mpqe_tpu_torch/tools/k8_probe.py host
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _setup():
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = mpqe_mod.MPQEConfig(**cs.FLAGSHIP)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = mpqe_mod.init_mpqe(gen, cfg, device=dev)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    return cs, cfg, dev, gen, model, flush


def check() -> None:
    import torch

    cs, cfg, dev, gen, model, flush = _setup()
    from mpqe_tpu_torch.ops import ring

    cs.build_kernels()
    if "--k8" not in sys.argv:
        cs.wide_rgcn_fused(cfg, dev, gen, flush)
        cs.wide_rgcn_blocked(cfg, dev, gen, flush)
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.parallel import halo

    layer, R = model.layers[0], cfg.n_rels
    cases = [c for c in cs.ring_cases(cfg, gen, dev)
             if (c["label"] == "general" and c["P"] in (2, 3))
             or c["label"] == "3-chain_inter"]
    for c in cases:
        P, x, n = c["P"], c["x"], c["n"]
        before = ring.rgcn_ring_halo_rdma.launches
        with torch.no_grad():
            got = ring.rgcn_ring_halo_rdma(c["mesh"], layer, x, *c["edges"],
                                           R)
            n_launch = ring.rgcn_ring_halo_rdma.launches - before
            again = ring.rgcn_ring_halo_rdma(c["mesh"], layer, x,
                                             *c["edges"], R)
            torch.cuda.synchronize()
            plain = ring.rgcn_ring_halo_rdma_reference(c["mesh"], layer, x,
                                                       *c["edges"], R)
            xla = halo.rgcn_ring_halo(c["mesh"], layer, x, *c["edges"], R)
            ref1 = rgcn_ops.rgcn_sparse(x[:n], layer, *c["single"], R)
            ctl = [ring.ring_gate(got, ring.rgcn_ring_halo_rdma_reference(
                c["mesh"], layer, x, *e, R))
                for e in ring.ring_controls(c["edges"], R, x.shape[0] // P)]
            gate = ring.ring_gate(got, plain, [(got, xla), (got[:n], ref1)])
            ms = cs.time_ms(lambda: ring.rgcn_ring_halo_rdma(
                c["mesh"], layer, x, *c["edges"], R), 5, flush)
            k_ms, copy_ms, _, _ = cs.ring_device_ms(
                lambda: ring.rgcn_ring_halo_rdma(c["mesh"], layer, x,
                                                 *c["edges"], R), 5, flush)
        print(f"check.k8 {c['label']} P={P} gate={gate} controls_ok="
              f"{[g['ok'] for g in ctl]} repeat_equal="
              f"{torch.equal(got, again)} launches={n_launch} (expected "
              f"{6 + 2 * P}) kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
              f"copy_stream_ms={copy_ms:.4f}", flush=True)


def _parent_lib(tree: Path, lib: str):
    """The library ``lib`` built from ``tree``'s csrc (argument types
    unset)."""
    import ctypes
    import subprocess

    from mpqe_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR / "parent"
    d.mkdir(parents=True, exist_ok=True)
    so = d / f"lib{lib}.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(so), str(tree / "mpqe_tpu_torch" / "csrc" /
                                  f"{lib}.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(so))


def same_bits(parent: str) -> None:
    import ctypes

    import torch

    cs, cfg, dev, gen, model, flush = _setup()
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    tree = Path(parent).resolve()
    here = {"rf": rf._kernel(), "rb": rb._kernel()}
    p5 = _parent_lib(tree, "rgcn_fused")
    p6 = _parent_lib(tree, "rgcn_blocked")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in ("mpqe_rgcn_msg_basis", "mpqe_rgcn_msg_wrel"):
        getattr(p5, fn).argtypes = getattr(here["rf"], fn).argtypes
        getattr(p5, fn).restype = i
    p6.mpqe_rgcn_blocked_forward.argtypes = \
        here["rb"].mpqe_rgcn_blocked_forward.argtypes
    p6.mpqe_rgcn_blocked_forward.restype = i
    # the parent's K6b entry point has no s_part argument
    p6.mpqe_rgcn_blocked_grad.argtypes = [
        p, p, i, p, p, i, i, i, i, p, p, p, i, p, p, i, p, p, p, p]
    p6.mpqe_rgcn_blocked_grad.restype = i

    class ParentGrad:  # this checkout's call, the parent's argument list
        def __getattr__(self, name):
            return getattr(p6, name)

        @staticmethod
        def mpqe_rgcn_blocked_grad(*a):
            return p6.mpqe_rgcn_blocked_grad(*a[:17], *a[18:])

    layer_b = model.layers[0]
    full = rgcn_ops.init_rgcn_layer(gen, cfg.embed_dim, cfg.embed_dim,
                                    cfg.n_rels, None, device=dev)
    basis, coeff = layer_b.basis.detach(), layer_b.coeff.detach()
    w_rel, R = full.w_rel.detach(), cfg.n_rels
    equal_all = True
    for label, B, ch, n in cs.k5_cases(cfg, gen, dev):
        if B == cs.TRAIN_BIG:
            continue
        src = ch["src"].to(torch.int32).contiguous()
        norm = ch["norm"].float().contiguous()
        crel = ch["chunk_rel"].to(torch.int32).contiguous()
        x = torch.randn((n, cfg.embed_dim), generator=gen, device=dev)
        outs = {}
        for side, lib in (("parent", p5), ("change", here["rf"])):
            rf._KERNEL = lib
            with torch.no_grad():
                outs[side] = (
                    rf.messages_basis(x, src, basis, coeff, crel, R, norm,
                                      ch["chunk"]),
                    rf.messages_wrel(x, src, w_rel, crel, norm, ch["chunk"]))
        rf._KERNEL = here["rf"]
        eq = [torch.equal(a, b) for a, b in zip(outs["parent"],
                                                outs["change"])]
        equal_all &= all(eq)
        print(f"same_bits K5a/K5b {label} B={B}: {eq}", flush=True)
    for label, B, bk, n in cs.k6_cases(cfg, gen, dev):
        if B != cs.TRAIN_BATCH:
            continue
        lay, t_lay = rb.layouts_on(bk, dev)
        x = torch.randn((n, cfg.embed_dim), generator=gen, device=dev)
        g = torch.randn((n, cfg.embed_dim), generator=gen, device=dev)
        outs = {}
        for side, lib in (("parent", ParentGrad()), ("change", here["rb"])):
            rb._KERNEL = lib
            with torch.no_grad():
                outs[side] = (
                    rb.messages_blocked(x, basis, coeff, lay, R),
                    rb.messages_blocked(g, basis.transpose(1, 2), coeff,
                                        t_lay, R),
                    *rb.grad_blocked_parts(x, g, basis, coeff, lay, R))
        rb._KERNEL = here["rb"]
        eq = [torch.equal(a, b) for a, b in zip(outs["parent"],
                                                outs["change"])]
        equal_all &= all(eq)
        print(f"same_bits K6a/K6a_t/K6b(dbasis,dcoeff,s) {label} B={B}: "
              f"{eq}", flush=True)
    print(f"same_bits: all equal={equal_all}", flush=True)
    if not equal_all:
        raise SystemExit(1)


def ab(parent: str, rounds: int = 3) -> None:
    import torch

    cs, cfg, dev, gen, model, flush = _setup()
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.tools.k3_probe import _parent_module

    old = _parent_module(Path(parent).resolve(), "ring", "ring")
    layer, R = model.layers[0], cfg.n_rels
    cases = [c for c in cs.ring_cases(cfg, gen, dev) if c["label"] !=
             "general"]
    sides = {"parent": old.rgcn_ring_halo_rdma,
             "change": ring.rgcn_ring_halo_rdma}
    res = {"parent": [], "change": []}
    with torch.no_grad():
        for _ in range(rounds):
            for side in ("parent", "change", "change", "parent"):
                fn = sides[side]
                wrap = host = 0.0
                for c in cases:
                    def call(c=c):
                        return fn(c["mesh"], layer, c["x"], *c["edges"], R)

                    wrap += cs.time_ms(call, 20, flush)
                    hs = []
                    for _ in range(20):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        call()
                        hs.append((time.perf_counter() - t0) * 1e3)
                    host += statistics.median(hs)
                torch.cuda.synchronize()
                res[side].append((wrap, host))
                print(f"ab.k8 {side}: sum of 7 wrapper_ms={wrap:.4f} "
                      f"host_ms={host:.4f}", flush=True)
    for side, v in res.items():
        print(f"ab.k8 {side} medians over {len(v)}: wrapper_ms="
              f"{statistics.median(w for w, _ in v):.4f} host_ms="
              f"{statistics.median(h for _, h in v):.4f}", flush=True)


def copies() -> None:
    import torch

    cs, cfg, dev, gen, model, flush = _setup()
    from mpqe_tpu_torch.ops import ring

    layer, R = model.layers[0], cfg.n_rels
    for c in cs.ring_cases(cfg, gen, dev):
        if c["label"] != "general":
            break
        P, x = c["P"], c["x"]
        block = x.shape[0] // P
        devs = c["mesh"].axis_devices("data")
        with torch.no_grad():
            groups = ring._groups(devs, layer, x, c["edges"], block, R)
        where = {p: (d, i) for d in groups
                 for i, p in enumerate(groups[d].parts)}
        plan = ring._copy_plan(groups, where, P)

        def hops():
            for s_ in range(P - 1):
                ring._copies(groups, plan, s_ % 2, (s_ + 1) % 2, devs[0])

        alone = cs.time_ms(hops, 20, flush)
        with torch.no_grad():
            _, in_ring, n_ops, _ = cs.ring_device_ms(
                lambda: ring.rgcn_ring_halo_rdma(c["mesh"], layer, x,
                                                 *c["edges"], R), 5, flush)
        nbytes = (P - 1) * P * block * x.shape[1] * 4
        print(f"copies general P={P}: {plan[devs[0]]} alone_ms={alone:.4f} "
              f"({nbytes / alone / 1e6:.1f} GB/s) in_ring_copy_stream_ms="
              f"{in_ring:.4f} ({n_ops} operations)", flush=True)
        del groups


def host() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    cs, cfg, dev, gen, model, flush = _setup()
    from mpqe_tpu_torch.ops import ring

    layer, R = model.layers[0], cfg.n_rels
    cases = [c for c in cs.ring_cases(cfg, gen, dev) if c["label"] !=
             "general"]

    def call(c):
        return ring.rgcn_ring_halo_rdma(c["mesh"], layer, c["x"],
                                        *c["edges"], R)

    total_host, total_dev = 0.0, 0.0
    with torch.no_grad():
        for c in cases:
            call(c)
            torch.cuda.synchronize()
            hs = []
            for _ in range(30):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(c)
                hs.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            k_ms = cs.ring_device_ms(lambda: call(c), 10, flush)[0]
            total_host += statistics.median(hs)
            total_dev += k_ms
            print(f"host.k8 {c['label']} P={c['P']} host_ms_p50="
                  f"{statistics.median(hs):.4f} device_ms={k_ms:.4f}",
                  flush=True)
        print(f"host.k8 sum of 7: host_ms={total_host:.4f} "
              f"device_ms={total_dev:.4f}", flush=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for c in cases:
                for _ in range(10):
                    call(c)
            torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    whole = sum(e.self_cpu_time_total for e in rows)
    print(f"host.k8 profile: CPU self time {whole / 1e3:.3f} ms over 70 "
          "calls; largest:", flush=True)
    for e in rows[:15]:
        print(f"host.k8   {e.key}: {e.self_cpu_time_total / 1e3:.3f} ms "
              f"({e.count} calls)", flush=True)


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else ""
    if cmd == "check":
        check()
    elif cmd == "same_bits" and len(sys.argv) == 3:
        same_bits(sys.argv[2])
    elif cmd == "ab" and len(sys.argv) in (3, 4):
        ab(sys.argv[2], *(int(a) for a in sys.argv[3:]))
    elif cmd == "copies":
        copies()
    elif cmd == "host":
        host()
    else:
        raise SystemExit(__doc__)
