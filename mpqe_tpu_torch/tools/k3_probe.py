#!/usr/bin/env python3
"""Measurements behind the K3 and K7 findings in PERF.md.

``ab PARENT [ROUNDS]`` (one CUDA card)
    The parent checkout PARENT's K3 and K7 (its ``ops/fused_fwd.py`` and
    ``ops/sddmm.py`` loaded as modules of their own, their libraries
    built from its ``csrc``) and this checkout's, in turns in one
    process (parent, change, change, parent; ROUNDS rounds, 3 unless
    given) on the flagship model: K3's kernel ms (CUDA events around the wrapper, L2
    flushed, mean of 50 calls) summed over the 7 structures at the
    serving batch B = 256, and its host ms per call (200 calls enqueued
    back to back, host clock) summed over the 7; K7's kernel ms at the
    chip-check shape (N = 512, E = 2,048), summed over the 7 batches'
    final-layer edges at B = 1,024, and at the cap (N = 8,191, E =
    2^20); then one server, its K3 switched, answers the serve stream of
    ``chip_smoke.py`` (28 requests of 256 queries of one structure, 4
    mixed) once to warm up and once timed: request p50 / p95 and
    queries/s, and for the single-structure requests the p50 of the rank
    step (``QueryServer._rank``: K3, the rank GEMM, the mode mask and
    ``top_k``) on the host clock and between CUDA events on the stream.
    Then the median of each figure per side.
``phases`` (one CUDA card)
    K3's device ms, summed over the 7 structures at B = 256, with
    ``csrc/fused_multi.cu`` rebuilt with one phase compiled out at a time
    (the products with their fragment loads, the weight staging, the x
    rows' load, the basis combination, the layer-0 variable messages),
    then with all of them: where the kernel's time goes.  The outputs of
    a build without a phase are wrong; only the times are read.
``emulate`` (CPU, ~5 minutes)
    The figures K3's gate (``ops/fused_fwd.py multi_gate``) is held to:
    the plain version, its activations kept, against itself with its
    products summed in another order (``_reordered_matmul``: exact sums,
    rounded once) at the widths of the card tests (d = 128 with 16
    bases, 16 with 4, 160 with 3, 400 with 2), B = 20, 256 and 1,000,
    the 7 structures, seeds 0 to 3, biases 0 or N(0, 0.1); then each
    negative control (``multi_gate_controls``) at queries 0, B/2 and
    B - 1, and its smallest failing figure over that figure's limit
    (above 1: it fails).

Usage: python3 mpqe_tpu_torch/tools/k3_probe.py ab runs/parent
       python3 mpqe_tpu_torch/tools/k3_probe.py phases
       python3 mpqe_tpu_torch/tools/k3_probe.py emulate
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WIDTHS = ((128, 16), (16, 4), (160, 3), (400, 2))  # (embed_dim, bases)

# (phase, text in csrc/fused_multi.cu, its replacement)
PHASES = (
    ("products",
     "        mma16816(acc[m][0], fa, fb[0], fb[1]);\n"
     "        mma16816(acc[m][1], fa, fb[2], fb[3]);\n", ""),
    ("weight staging", "    if (t < n_tiles) {\n      const int p = t / tpp",
     "    if (false) {\n      const int p = t / tpp"),
    ("x rows", "  if (l == 0) {\n    const int per = TQ * dp;",
     "  if (true) {\n  } else if (l == 0) {\n    const int per = TQ * dp;"),
    ("basis combination", "    if (pass_end && !self) {",
     "    if (false) {"),
    ("variable messages", "    if (ly.e_sp[e] >= 0) continue;",
     "    continue;"),
    ("all of the above", None, None),
)


def _parent_module(tree: Path, name: str, lib: str):
    """``mpqe_tpu_torch/ops/<name>.py`` of the checkout ``tree`` as a
    module of its own, its library ``lib`` built from that checkout's
    ``csrc`` (the rest of the package is this one's)."""
    import importlib.util

    from mpqe_tpu_torch.ops import cuda_build

    spec = importlib.util.spec_from_file_location(
        f"parent_{name}", tree / "mpqe_tpu_torch" / "ops" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    here, mine = cuda_build.CSRC_DIR, cuda_build._LOADED.pop(lib, None)
    cuda_build.CSRC_DIR = tree / "mpqe_tpu_torch" / "csrc"
    try:
        mod._kernel()
    finally:
        cuda_build.CSRC_DIR = here
        cuda_build._LOADED.pop(lib, None)
        if mine is not None:
            cuda_build._LOADED[lib] = mine
    return mod


def ab(parent: str, rounds: int = 3) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from mpqe_tpu_torch.data.sampler import make_random_kg
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.ops import sddmm as sd
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.serve import QueryServer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"ab: {torch.cuda.get_device_name(0)}", flush=True)
    pff = _parent_module(Path(parent).resolve(), "fused_fwd", "fused_multi")
    psd = _parent_module(Path(parent).resolve(), "sddmm", "sddmm")
    ff._kernel()
    sd._kernel()
    cfg = mpqe_mod.MPQEConfig(**cs.FLAGSHIP)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = mpqe_mod.init_mpqe(gen, cfg, device=dev)
    with torch.no_grad():
        for lp in model.layers:
            lp.bias.normal_(0.0, 0.1, generator=gen)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    own = ff.fused_tgt_forward_multi
    k3 = {"parent": (pff.fused_tgt_forward_multi,
                     pff.prepare_fused_multi(model, cfg)),
          "change": (own, ff.prepare_fused_multi(model, cfg))}
    k7 = {"parent": psd.sddmm_kernel, "change": sd.sddmm_kernel}
    k3_args = [(s, cs.random_inputs(gen, cfg, s, cs.BATCH, dev))
               for s in STRUCTURE_NAMES]
    kg = make_random_kg(**cs.KG)
    server = QueryServer(model, cfg, kg.entity_mode, device=dev)
    single, mixed = cs.sample_stream(kg)
    rng = np.random.default_rng(12)
    g7 = torch.Generator(dev).manual_seed(4)

    def rand_case(n, E):
        x = torch.randn((n, cfg.embed_dim), device=dev, generator=g7)
        y = torch.randn((n, cfg.embed_dim), device=dev, generator=g7)
        ids = [torch.from_numpy(rng.integers(0, n, E).astype(np.int32)).to(
            dev) for _ in range(2)]
        return (x, y, *ids)

    def t(a):
        return torch.from_numpy(a).to(dev)

    k7_cases = (
        ("tpu_smoke", [rand_case(512, 2048)], cs.ITERS),
        ("sum_of_7", [(x, x, t(sb.edges.src), t(sb.edges.dst)) for x, sb in
                      ((cs.final_layer_nodes(model, cfg, sb, dev), sb)
                       for _, sb in cs.eval_batches(cfg, rng))], cs.ITERS),
        ("cap", [rand_case(cs.K7_CAP_NODES, cs.CAP_ROWS)], cs.BIG_ITERS))
    rank_split = []

    def rank_timed(fn):
        def run(*a, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            t0 = time.perf_counter()
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            host = (time.perf_counter() - t0) * 1e3
            e1.synchronize()
            rank_split.append((host, e0.elapsed_time(e1)))
            return out
        return run

    res = {"parent": {}, "change": {}}
    try:
        for r in range(rounds):
            for v in ("parent", "change", "change", "parent"):
                fn, ops = k3[v]
                ff.fused_tgt_forward_multi = fn
                server._k3 = ops
                row = {}
                with torch.inference_mode():
                    row["k3_kernel_ms"] = sum(cs.time_ms(
                        lambda: fn(model, cfg, s, *args, operands=ops),
                        cs.ITERS, flush) for s, args in k3_args)
                    host = 0.0
                    for s, args in k3_args:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(200):
                            fn(model, cfg, s, *args, operands=ops)
                        host += (time.perf_counter() - t0) / 200 * 1e3
                        torch.cuda.synchronize()
                    row["k3_host_ms"] = host
                    for label, cases, iters in k7_cases:
                        row[f"k7_{label}_ms"] = sum(cs.time_ms(
                            lambda: k7[v](*c), iters, flush) for c in cases)
                for req in single + mixed:  # warm pass
                    server.answer(req, k=cs.K)
                rank_split.clear()
                server._rank = rank_timed(QueryServer._rank.__get__(server))
                lat = []
                for req in single:
                    t0 = time.perf_counter()
                    server.answer(req, k=cs.K)
                    lat.append((time.perf_counter() - t0) * 1e3)
                del server._rank
                for req in mixed:
                    t0 = time.perf_counter()
                    server.answer(req, k=cs.K)
                    lat.append((time.perf_counter() - t0) * 1e3)
                lat = np.asarray(lat)
                rank = np.asarray(rank_split)
                row["serve_p50_ms"] = float(np.percentile(lat, 50))
                row["serve_p95_ms"] = float(np.percentile(lat, 95))
                row["queries_per_s"] = len(lat) * cs.BATCH / lat.sum() * 1e3
                row["rank_host_p50_ms"] = float(np.percentile(rank[:, 0], 50))
                row["rank_device_p50_ms"] = float(
                    np.percentile(rank[:, 1], 50))
                for k, x in row.items():
                    res[v].setdefault(k, []).append(x)
                print(f"ab round {r} {v:6s} " + " ".join(
                    f"{k}={x:.4f}" for k, x in row.items()), flush=True)
    finally:
        ff.fused_tgt_forward_multi = own
    for v, rows in res.items():
        print(f"ab median of {len(rows['serve_p50_ms'])} {v:6s} " + " ".join(
            f"{k}={np.median(x):.4f}" for k, x in rows.items()), flush=True)


def _variant(name: str, source: str, lib0):
    """Build ``source`` with the K3 library's flags and entry points."""
    from mpqe_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR / "k3_phases"
    d.mkdir(parents=True, exist_ok=True)
    cu, so = d / f"{name}.cu", d / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("mpqe_fused_multi_forward", "mpqe_fused_multi_plan",
               "mpqe_fused_multi_plan_free", "mpqe_fused_multi_plan_smem",
               "mpqe_fused_multi_blocks", "mpqe_fused_multi_max_smem"):
        getattr(lib, fn).argtypes = getattr(lib0, fn).argtypes
        getattr(lib, fn).restype = getattr(lib0, fn).restype
    return lib


def phases() -> None:
    import torch

    import chip_smoke as cs
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import cuda_build
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    torch.backends.cuda.matmul.allow_tf32 = False
    source = (cuda_build.CSRC_DIR / "fused_multi.cu").read_text()
    lib0 = ff._kernel()
    libs = {"all phases": lib0}
    rest = source
    for i, (name, old, new) in enumerate(PHASES):
        if old is None:  # every phase above compiled out at once
            libs[name] = _variant(f"v{i}", rest, lib0)
            continue
        if source.count(old) != 1:
            raise AssertionError(f"phase {name!r} not found in the source")
        rest = rest.replace(old, new)
        libs[f"without {name}"] = _variant(f"v{i}", source.replace(old, new),
                                           lib0)
    cfg = mpqe_mod.MPQEConfig(**cs.FLAGSHIP)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = mpqe_mod.init_mpqe(gen, cfg, device=dev)
    ops = ff.prepare_fused_multi(model, cfg)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    print(f"phases: {torch.cuda.get_device_name(0)}", flush=True)
    cases = [(s, cs.random_inputs(gen, cfg, s, cs.BATCH, dev))
             for s in STRUCTURE_NAMES]
    for name, lib in libs.items():
        ff._KERNEL = lib
        ops.descs.clear()
        tot = 0.0
        with torch.inference_mode():
            for s, args in cases:
                tot += cs.device_ms(lambda: ff.fused_tgt_forward_multi(
                    model, cfg, s, *args, operands=ops), 20, flush,
                    cs.K3_KERNELS, per_call=mpqe_mod.num_steps(cfg, s))
        print(f"phases K3 B={cs.BATCH} sum of 7 {name:28s} "
              f"device_ms={tot:.4f}", flush=True)
    ff._KERNEL = lib0


def emulate() -> None:
    import numpy as np
    import torch

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    torch.set_num_threads(4)
    for d, nb in WIDTHS:
        cfg = mpqe_mod.MPQEConfig(n_entities=5000, n_modes=4, n_rels=266,
                                  embed_dim=d, n_layers=3, num_bases=nb)
        worst, ratio, cases, failed = {}, {}, 0, 0
        for seed in range(4):
            gen = torch.Generator().manual_seed(seed)
            model = mpqe_mod.init_mpqe(gen, cfg)
            with torch.no_grad():
                for lp in model.layers:
                    if seed % 2:
                        lp.bias.normal_(0.0, 0.1, generator=gen)
            ops = ff.prepare_fused_multi(model, cfg)
            for B in (20, 256, 1000):
                for structure in STRUCTURE_NAMES:
                    spec = STRUCTURES[structure]
                    rng = np.random.default_rng(seed * 7 + B)
                    args = [torch.from_numpy(a) for a in (
                        rng.integers(0, 5000, (B, spec.n_nodes)).astype(
                            np.int32),
                        rng.integers(0, 4, (B, spec.n_nodes)).astype(
                            np.int32),
                        rng.integers(0, 266, (B, spec.n_edges)).astype(
                            np.int32),
                        rng.uniform(0.5, 1.5, (B, spec.n_edges)).astype(
                            np.float32))]
                    L = mpqe_mod.num_steps(cfg, structure)
                    side = "L1" if L == 1 else "deep"
                    with torch.no_grad():
                        emu, acts = ff.fused_tgt_forward_multi_layers(
                            model, cfg, structure, *args, operands=ops,
                            mm=ff._reordered_matmul)
                        gate = ff.multi_gate(cfg, structure, ops, args, emu,
                                             acts)
                        failed += not gate["ok"]
                        for k, v in gate.items():
                            if k != "ok":
                                key = f"{side} {k}" + (
                                    " B>=256" if B >= 256 else "")
                                worst[key] = max(worst.get(key, 0.0), v)
                        for q in (0, B // 2, B - 1):
                            for name, o2, ne, er in ff.multi_gate_controls(
                                    cfg, structure, ops, args[0], args[2],
                                    q):
                                g = ff.multi_gate(
                                    cfg, structure, o2,
                                    (ne, args[1], er, args[3]), emu, acts)
                                failed += g["ok"]
                                # the figure that fails it, over its limit
                                v = max(g["steps"] / 1.0,
                                        g["last"] / ff.FLIP_FREE_TOL)
                                key = (name, structure)
                                ratio[key] = min(ratio.get(key, float("inf")),
                                                 v)
                    cases += 1
        print(f"emulate d={d} bases={nb}: {cases} cases (7 structures x B "
              f"in 20, 256, 1000 x seeds 0-3; odd seeds with biases "
              f"N(0, 0.1)), controls at queries 0, B/2, B-1; {failed} "
              f"wrong verdicts", flush=True)
        for key, v in sorted(worst.items()):
            print(f"emulate d={d}: reordering {key:22s} worst {v:.3e}")
        for (name, structure), v in sorted(ratio.items()):
            print(f"emulate d={d}: control {name:10s} {structure:14s} "
                  f"smallest failing figure / limit {v:.2f}")


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["ab"] and len(argv) in (2, 3):
        ab(argv[1], *map(int, argv[2:]))
    elif argv == ["phases"]:
        phases()
    elif argv == ["emulate"]:
        emulate()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
