#!/usr/bin/env python3
"""Measurements behind the K6 findings in PERF.md, on one CUDA card.

``ab TREE [TREE ...]``
    ``train.blocked`` of ``chip_smoke.py`` (50 seeded steps at batch 512,
    the flagship model) from each checkout TREE in turn, each in a
    process of its own: its step p50 / p95 line.  To compare two commits,
    unpack both (``git archive``) and pass them in turns: parent, change,
    change, parent.
``phases``
    K6a's and K6b's device ms on 3-chain at B = 131,072 and on the
    general graph with ``csrc/rgcn_blocked.cu`` rebuilt with one phase
    compiled out at a time, then with all of them (the gathers, lists and
    synchronisation left): where the kernels' time goes.  The outputs of
    a build without a phase are wrong; only the times are read.

``emulate`` (CPU)
    How often K6b's s_eb lands off the plain value when the products'
    K-deep sums take another order: ``h_b`` summed exactly (float64, then
    rounded) and ``sum_o h_b gn`` pairwise, against the plain version's
    one-by-one sums, at d = 128 over 200,000 seeded edges and 4 bases:
    the share one bf16 step off and the count further.

Usage: python3 mpqe_tpu_torch/tools/k6_probe.py ab runs/parent runs/pr
       python3 mpqe_tpu_torch/tools/k6_probe.py phases
       python3 mpqe_tpu_torch/tools/k6_probe.py emulate
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

AB_RUN = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mpqe_tpu_torch.data.sampler import make_random_kg
torch.backends.cuda.matmul.allow_tf32 = False
cs.build_kernels()
kg = make_random_kg(**cs.KG)
train_q, _ = cs.sample_train_queries(kg)
cs.phase_train_sparse(kg, train_q, torch.device("cuda"), "train.blocked")
"""

# (phase, kernel, text in csrc/rgcn_blocked.cu, its replacement)
PHASES = (
    ("products", "K6a", "for (int b = 0; b < P.bb; b += 2) {",
     "for (int b = 0; b < 0; b += 2) {"),
    ("destination sum", "K6a",
     "    {\n      const int c = tid % CW, seg = tid / CW, col = col0 + c;",
     "    if (false) {\n      const int c = tid % CW, seg = tid / CW, "
     "col = col0 + c;"),
    ("xs @ V_b and s_eb", "K6b",
     "    // h_b = xs @ V_b for edges [16 wm, 16 wm + 16) x columns\n"
     "    // [64 wn, 64 wn + 64); the partial sums of h_b * gn over them\n"
     "    if (with_s) {", "    if (false) {"),
    ("xs^T @ rhs", "K6b",
     "    // dbasis[b] += xs^T @ rhs over the tile's 64 edges\n    {",
     "    if (false) {"),
    ("rhs", "K6b", "    if (2 * (tid & 63) < NP) {", "    if (false) {"),
    ("all but the gathers", "K6a+K6b", None, None),
)


def ab(trees) -> None:
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", AB_RUN], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines() if "step_ms_p50" in ln]
        print(f"ab {tree} rc={out.returncode}: " + " | ".join(lines),
              flush=True)
        if out.returncode:
            print(out.stderr[-2000:], flush=True)


def _variant(name: str, source: str, lib0):
    """Build ``source`` with the K6 library's flags and entry points."""
    from mpqe_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR / "k6_phases"
    d.mkdir(parents=True, exist_ok=True)
    cu, so = d / f"{name}.cu", d / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("mpqe_rgcn_blocked_forward", "mpqe_rgcn_blocked_grad"):
        getattr(lib, fn).argtypes = getattr(lib0, fn).argtypes
        getattr(lib, fn).restype = getattr(lib0, fn).restype
    return lib


def phases() -> None:
    import torch

    import chip_smoke as cs
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import cuda_build
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import template_layout as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    source = (cuda_build.CSRC_DIR / "rgcn_blocked.cu").read_text()
    libs = {"all phases": rb._kernel()}
    gathers_only = source
    for i, (name, _, old, new) in enumerate(PHASES):
        if old is None:  # every phase above compiled out at once
            libs[name] = _variant(f"v{i}", gathers_only, libs["all phases"])
            continue
        if source.count(old) != 1:
            raise AssertionError(f"phase {name!r} not found in the source")
        gathers_only = gathers_only.replace(old, new)
        libs[f"without {name}"] = _variant(f"v{i}", source.replace(old, new),
                                           libs["all phases"])
    cfg = mpqe_mod.MPQEConfig(**cs.FLAGSHIP)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = mpqe_mod.init_mpqe(gen, cfg, device=dev).layers[0]
    basis, coeff = layer.basis.detach(), layer.coeff.detach()
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    er, en = cs.template_rel_norm(gen, cfg, "3-chain")
    cases = (("3-chain B=131072",
              tl.template_blocked("3-chain", er, en, cs.TRAIN_BIG),
              cs.TRAIN_BIG * 4),
             ("general", rb.bucket_edges_blocked(cs.general_store(cfg)),
              cs.GENERAL_NODES))
    for label, bk, n in cases:
        lay = rb.layout_on(bk, dev)
        x = torch.randn((n, cfg.embed_dim), generator=gen, device=dev)
        g = torch.randn((n, cfg.embed_dim), generator=gen, device=dev)
        for name, lib in libs.items():
            rb._KERNEL = lib
            with torch.no_grad():
                a = cs.device_ms(lambda: rb.messages_blocked(
                    x, basis, coeff, lay, cfg.n_rels), 5, flush,
                    cs.K6A_KERNELS)
                b = cs.device_ms(lambda: rb.grad_blocked(
                    x, g, basis, coeff, lay, cfg.n_rels), 5, flush,
                    cs.K6B_KERNELS)
            print(f"phases {label:16s} {name:26s} K6a_device_ms={a:.4f} "
                  f"K6b_device_ms={b:.4f}", flush=True)
        rb._KERNEL = libs["all phases"]


def emulate(E: int = 200_000, K: int = 128, bb: int = 4) -> None:
    import torch

    from mpqe_tpu_torch.ops import rgcn_blocked as rb

    torch.manual_seed(0)
    xs = rb._bf16(torch.randn(E, K))
    vb = rb._bf16(torch.randn(bb, K, K) / K ** 0.5)
    gn = rb._bf16(torch.randn(E, K)) * (0.5 + torch.rand(E, 1))
    one, more = 0, 0
    for b in range(bb):
        prod = rb._ordered_matmul(xs, vb[b]) * gn
        s_plain = xs.new_zeros(E)
        for o in range(K):
            s_plain = s_plain + prod[:, o]
        h = (xs.double() @ vb[b].double()).float()
        s_other = (h * gn).double().sum(1).float()
        steps = rb._bf16_steps(rb._bf16(s_other), rb._bf16(s_plain))
        one += int((steps == 1).sum())
        more += int((steps > 1).sum())
    print(f"emulate: {E * bb} s_eb, one bf16 step off {one / (E * bb):.3e}, "
          f"further {more}")


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
