#!/usr/bin/env python3
"""Measurements behind the K5a/K5b findings in PERF.md.

``emulate`` (CPU)
    The figures behind K5's split-TF32 product: K5a's and K5b's messages
    with the product emulated in the kernel's order (``emulated_messages``,
    three TF32 passes) and with one TF32 pass (the negative control),
    against the f32 batched oracle (``ops/rgcn_fused.py
    _edge_messages_xla``, gate 1e-5) and the plain versions (gate 1e-4),
    max|diff| / max|ref|, at d = 128 and 16 on a template layout
    (``3-chain_inter``) and a ``chunk_by_relation`` layout, seeds 0 to 2.
    Then the bf16-row variant (``emulate_bf16_case``): on bf16 rows, whose
    lo halves are 0, the two passes the kernel keeps (hi.lo, hi.hi) against
    all three, bit for bit, and against the gates, at d = 16, 128 and 200
    on both layouts.
``ab TREE [TREE ...]`` (one CUDA card)
    One ``--kernel fused`` train step of ``3-chain_inter`` (the flagship
    model with 16 bases, K5a, and with full weights, K5b; 4 negatives,
    Adam) at B = 512 and at B = 131,072, from each checkout TREE in turn,
    each in a process of its own: the median step ms of 20 timed steps
    after 3 warm ones (host clock, the loss read each step).  To compare
    two commits, unpack both (``git archive``) and pass them in turns:
    parent, change, change, parent.
``phases`` (one CUDA card)
    K5a's and K5b's device ms on the general graph and on
    ``3-chain_inter`` at B = 512 and 131,072 with ``csrc/rgcn_fused.cu``
    rebuilt with one phase compiled out at a time (the W tile loads,
    K5a's prologue, the next tile's gather, the two correction products
    of the three TF32 passes, all products, the output stores), then with
    all of them (the barriers, the row indices and the norms left): where
    the kernel's time goes.  The outputs of a build without a phase are wrong; only
    the times are read.

Usage: python3 mpqe_tpu_torch/tools/k5_probe.py emulate
       python3 mpqe_tpu_torch/tools/k5_probe.py ab runs/parent . . runs/parent
       python3 mpqe_tpu_torch/tools/k5_probe.py phases
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 stored mantissa bits) by bit masking: half
    of the dropped 13 bits' range added to the magnitude, then the 13 bits
    cleared: to nearest, ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32 (its 13 low mantissa bits cleared): how the
    tensor core reads an f32 operand that is not TF32 (the kernel's lo)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def f32_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """f64 to f32 rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def emulated_messages(x: torch.Tensor, src, w_c: torch.Tensor,
                      norm: torch.Tensor, chunk: int,
                      passes: int = 3) -> torch.Tensor:
    """K5's messages ``(x[src] @ w_c[chunk]) * norm`` with the product
    taken in the kernel's order: each f32 operand split into hi = tf32(a)
    and lo = a - hi, read truncated to TF32; k zero-padded to a multiple
    of 16 and walked in the kernel's 8-deep steps (step s of slice k0:
    k0 + 4 q + 2 s + h, q < 4, h < 2); per step the mma products lo.hi,
    hi.lo, hi.hi (``passes=3``), hi.lo and hi.hi (``passes=2``, the
    bf16-row kernel's: it skips lo.hi) or hi.hi alone (``passes=1``, one
    TF32 pass), each an exact 8-term sum added to the f32 accumulator and
    rounded toward zero, as a model of the tensor core's f32 accumulation;
    then ``* norm`` in f32.  Rounding to nearest there instead gives a
    third of the error that the card shows (PERF.md)."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    xs = rf._gather_rows(x, src).to(torch.float32)
    K, N = xs.shape[1], w_c.shape[2]
    kp = (K + 15) // 16 * 16
    xs = torch.nn.functional.pad(xs, (0, kp - K))
    w_c = torch.nn.functional.pad(w_c.to(torch.float32), (0, 0, 0, kp - K))
    xh = tf32(xs)
    xl = tf32_trunc(xs - xh)
    wh = tf32(w_c)
    wl = tf32_trunc(w_c - wh)
    xh, xl = (t.reshape(-1, chunk, kp).double() for t in (xh, xl))
    wh, wl = wh.double(), wl.double()
    pairs = {3: ((xl, wh), (xh, wl), (xh, wh)), 2: ((xh, wl), (xh, wh)),
             1: ((xh, wh),)}[passes]
    acc = torch.zeros((xh.shape[0], chunk, N), dtype=torch.float32)
    for k0 in range(0, kp, 16):
        for s in range(2):
            ks = [k0 + 4 * q + 2 * s + h for q in range(4) for h in range(2)]
            for a, b in pairs:
                p = torch.einsum("cek,ckn->cen", a[:, :, ks], b[:, ks, :])
                acc = f32_toward_zero(acc.double() + p)
    return acc.reshape(-1, N) * norm[:, None]


def _case(d: int, layout: str, seed: int, n_rels: int, bf16: bool = False):
    """The inputs of one ``emulate`` case: ``(x, src, norm, chunk, [(w_c,
    plain, oracle) of K5a, of K5b])``; ``bf16``: the rows rounded to
    bf16."""
    import numpy as np

    from mpqe_tpu_torch.ops import edge_store as es
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURES

    rng = np.random.default_rng(seed)
    if layout == "template":
        s = "3-chain_inter"
        spec = STRUCTURES[s]
        B = 128
        ch = tl.template_chunked(
            s, torch.from_numpy(rng.integers(0, n_rels, spec.n_edges).astype(
                np.int32)),
            torch.from_numpy(rng.uniform(0.5, 1.5, spec.n_edges).astype(
                np.float32)), B, 32)
        n = B * spec.n_nodes
    else:
        n, n_e = 500, 2000
        st = es.build_edge_store(rng.integers(0, n, n_e),
                                 rng.integers(0, n, n_e),
                                 rng.integers(0, n_rels, n_e), n, n_rels)
        ch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
              for k, v in rf.chunk_by_relation(st, 32).items()}
    src, norm = ch["src"].to(torch.int32), ch["norm"].to(torch.float32)
    crel, chunk = ch["chunk_rel"].to(torch.int32), ch["chunk"]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = t(rng.normal(size=(n, d)))
    if bf16:
        x = x.to(torch.bfloat16)
    basis = t(rng.normal(size=(4, d, d)) / d ** 0.5)
    coeff = t(rng.normal(size=(n_rels, 4)))
    w_rel = torch.einsum("rb,bio->rio", coeff, basis).contiguous()
    eye = torch.eye(n_rels)
    ce = rf._masked_chunk_coeff(coeff, crel, n_rels)
    rc = crel.clamp(0, n_rels - 1)
    return x, src, norm, chunk, (
        (rf.combine_basis(basis, ce),
         rf.messages_basis_reference(x, src, basis, ce, norm, chunk),
         rf._edge_messages_xla(x, basis, coeff, src, norm, crel, n_rels,
                               chunk)),
        (w_rel[rc.long()],
         rf.messages_wrel_reference(x, src, w_rel, rc, norm, chunk),
         rf._edge_messages_xla(x, w_rel, eye, src, norm, crel, n_rels,
                               chunk)))


def emulate_case(d: int, layout: str, seed: int, n_rels: int = 8):
    """One case of ``emulate``: (K5a, K5b) dicts of the emulated products'
    errors, keys ``{3,1}x_vs_{oracle,plain}`` (max|diff| / max|ref|)."""
    x, src, norm, chunk, kernels = _case(d, layout, seed, n_rels)
    out = []
    for w_c, plain, oracle in kernels:
        errs = {}
        for passes in (3, 1):
            got = emulated_messages(x, src, w_c, norm, chunk, passes)
            for name, ref in (("oracle", oracle), ("plain", plain)):
                errs[f"{passes}x_vs_{name}"] = float(
                    (got - ref).abs().max() / ref.abs().max())
        out.append(errs)
    return out


def emulate_bf16_case(d: int, layout: str, seed: int, n_rels: int = 8):
    """One bf16-row case of ``emulate``: per kernel (K5a, K5b) whether the
    two passes the bf16-row kernel keeps give the three passes' bits on
    the same bf16 rows, and the two passes' errors ``2x_vs_{oracle,plain}``
    against the gates."""
    x, src, norm, chunk, kernels = _case(d, layout, seed, n_rels, True)
    out = []
    for w_c, plain, oracle in kernels:
        three = emulated_messages(x, src, w_c, norm, chunk, 3)
        two = emulated_messages(x, src, w_c, norm, chunk, 2)
        out.append({"bit_equal": torch.equal(three.view(torch.int32),
                                              two.view(torch.int32)),
                    **{f"2x_vs_{name}": float((two - ref).abs().max()
                                              / ref.abs().max())
                       for name, ref in (("oracle", oracle),
                                         ("plain", plain))}})
    return out


def emulate() -> None:
    torch.set_num_threads(4)
    worst = {}
    for d in (128, 16):
        for layout in ("template", "general"):
            for seed in range(3):
                for kid, errs in zip(("K5a", "K5b"),
                                     emulate_case(d, layout, seed)):
                    print(f"emulate d={d:3d} {layout:8s} seed={seed} {kid}: "
                          + " ".join(f"{k}={v:.3e}"
                                     for k, v in errs.items()), flush=True)
                    for k, v in errs.items():
                        lo, hi = worst.get(k, (1.0, 0.0))
                        worst[k] = (min(lo, v), max(hi, v))
    for k, (lo, hi) in worst.items():
        print(f"emulate: {k} from {lo:.3e} to {hi:.3e} (gates: oracle 1e-5, "
              "plain 1e-4)")
    for d in (16, 128, 200):
        for layout in ("template", "general"):
            for kid, r in zip(("K5a", "K5b"), emulate_bf16_case(d, layout,
                                                                0)):
                print(f"emulate bf16 rows d={d:3d} {layout:8s} {kid}: two "
                      f"passes bit-equal to three: {r['bit_equal']}; "
                      f"2x_vs_oracle={r['2x_vs_oracle']:.3e} "
                      f"2x_vs_plain={r['2x_vs_plain']:.3e}", flush=True)


AB_RUN = r"""
import statistics, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.ops import rgcn_fused as rf
from mpqe_tpu_torch.queries import STRUCTURES
from mpqe_tpu_torch.train import loop as loop_mod
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
structure = "3-chain_inter"
spec = STRUCTURES[structure]
for nb in (16, None):
    cfg = mpqe_mod.MPQEConfig(**dict(cs.FLAGSHIP, num_bases=nb))
    fn = rf.messages_basis if nb else rf.messages_wrel
    for B in (512, 131072):
        tc = loop_mod.TrainConfig(lr=0.01, batch_size=B, n_neg=4)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = loop_mod.init_train_state(gen, cfg, tc, device=dev)
        step = loop_mod.make_train_step(
            cfg, state.optimizer, mpqe_mod.dense_batch_loss_kernel_fused)

        def ints(high, shape):
            return torch.randint(0, high, shape, generator=gen, device=dev,
                                 dtype=torch.int32)

        batch = (ints(cfg.n_entities, (B, spec.n_nodes)),
                 ints(cfg.n_modes, (B, spec.n_nodes)),
                 ints(cfg.n_rels, (spec.n_edges,)),
                 0.5 + torch.rand((spec.n_edges,), generator=gen, device=dev),
                 ints(cfg.n_entities, (B,)), ints(cfg.n_entities, (B, 4)),
                 torch.ones((B, 4), device=dev), torch.ones((B,), device=dev))
        ms = []
        k5 = fn.launches
        for i in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(state.model, structure, *batch))
            ms.append((time.perf_counter() - t0) * 1e3)
        k5 = fn.launches - k5
        ms = ms[3:]
        print(f"ab step {structure} {'K5a' if nb else 'K5b'} B={B}: "
              f"median_ms={statistics.median(ms):.3f} min_ms={min(ms):.3f} "
              f"max_ms={max(ms):.3f} loss={loss:.6f} launches={k5}",
              flush=True)
        del state, step, batch
        torch.cuda.empty_cache()
"""


def ab(trees) -> None:
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", AB_RUN], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("ab ")]
        print(f"ab {tree} rc={out.returncode}: " + " | ".join(lines),
              flush=True)
        if out.returncode:
            print(out.stderr[-2000:], flush=True)


# (phase, [(text in csrc/rgcn_fused.cu, its replacement), ...])
PHASES = (
    ("W tile loads", [(
        "    if (ns > 1 || slot != wslot) build_w<S>(a, slot, col0, st * a.KS, "
        "kw, ws);\n", "")]),
    ("K5a prologue", [(
        "  k5_combine_kernel<<<grid, CB_THREADS, 0, s>>>(basis, bb, coeff, "
        "crel,\n", "  if (false) k5_combine_kernel<<<grid, CB_THREADS, 0, s>>>("
        "basis, bb, coeff, crel,\n")]),
    ("next gather", [(
        "      gather<S, ST, Row>(a, xs0 + (buf ^ 1) * TM * P, idx, st1 * "
        "a.KS, kw1,\n                         (kw1 + 15) / 16 * 16, warp, "
        "lane);\n",
        "")]),
    # two of the three TF32 passes: what the split costs in products
    ("correction products", [
        ("            mma_tf32(acc[mi][nj], al[mi], bh[nj]);\n",
         "            ;\n"),
        ("        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], ah[mi], "
         "bl[nj]);\n", "        ;\n")]),
    ("products", [(
        "    tile_products<S, Row>(xs0 + buf * TM * P, ws, P, (kw + 15) / 16 "
        "* 16,\n                          wm, wn, lane, acc);\n", "")]),
    # the stores out, every sum still read (never true)
    ("stores", [(
        "              *reinterpret_cast<float2*>(o + col) = make_float2(v0, "
        "v1);\n", "              if (v0 == 1.2345e-30f) o[col] = v1;\n")]),
    ("all but indices, norms and barriers", None),
)


def _variant(name: str, source: str, lib0):
    """Build ``source`` with the K5 library's flags and entry points."""
    from mpqe_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR / "k5_phases"
    d.mkdir(parents=True, exist_ok=True)
    cu, so = d / f"{name}.cu", d / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("mpqe_rgcn_msg_basis", "mpqe_rgcn_msg_wrel"):
        getattr(lib, fn).argtypes = getattr(lib0, fn).argtypes
        getattr(lib, fn).restype = getattr(lib0, fn).restype
    return lib


def phases() -> None:
    import chip_smoke as cs
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import cuda_build
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    torch.backends.cuda.matmul.allow_tf32 = False
    source = (cuda_build.CSRC_DIR / "rgcn_fused.cu").read_text()
    libs = {"all phases": rf._kernel()}
    one_launch = set()  # K5a builds without the prologue: one launch a call
    rest = source
    for i, (name, edits) in enumerate(PHASES):
        if edits is None:  # every phase above compiled out at once
            libs[name] = _variant(f"v{i}", rest, libs["all phases"])
            one_launch.add(name)
            continue
        one = source
        for old, new in edits:
            if source.count(old) != 1:
                raise AssertionError(f"phase {name!r} not found in the "
                                     "source")
            one = one.replace(old, new)
            if old in rest:
                rest = rest.replace(old, new)
        libs[f"without {name}"] = _variant(f"v{i}", one, libs["all phases"])
        if name == "K5a prologue":
            one_launch.add(f"without {name}")
    cfg = mpqe_mod.MPQEConfig(**cs.FLAGSHIP)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = rgcn_ops.init_rgcn_layer(gen, 128, 128, cfg.n_rels, 16,
                                     device=dev)
    w_rel = torch.einsum("rb,bio->rio", layer.coeff, layer.basis).detach()
    basis, coeff = layer.basis.detach(), layer.coeff.detach()
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    print(f"phases: {torch.cuda.get_device_name(0)}", flush=True)
    want = {"3-chain_inter": (cs.TRAIN_BATCH, cs.TRAIN_BIG), "general": (0,)}
    for label, B, ch, n in cs.k5_cases(cfg, gen, dev):
        if B not in want.get(label, ()):
            continue
        src = ch["src"].to(torch.int32).contiguous()
        norm = ch["norm"].float().contiguous()
        crel = ch["chunk_rel"].to(torch.int32).contiguous()
        chunk = ch["chunk"]
        x = torch.randn((n, 128), generator=gen, device=dev)
        rc = crel.clamp(0, cfg.n_rels - 1)
        iters = cs.ITERS if B == cs.TRAIN_BATCH else cs.BIG_ITERS
        for name, lib in libs.items():
            rf._KERNEL = lib
            with torch.no_grad():
                a = cs.device_ms(lambda: rf.messages_basis(
                    x, src, basis, coeff, crel, cfg.n_rels, norm, chunk),
                    iters, flush, cs.K5_KERNELS,
                    1 if name in one_launch else 2)
                b = cs.device_ms(lambda: rf.messages_wrel(
                    x, src, w_rel, rc, norm, chunk), iters, flush,
                    cs.K5_KERNELS)
            print(f"phases {label} B={B:6d} {name:40s} K5a_device_ms={a:.4f} "
                  f"K5b_device_ms={b:.4f}", flush=True)
        rf._KERNEL = libs["all phases"]


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["ab"] and len(argv) > 1:
        ab(argv[1:])
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
