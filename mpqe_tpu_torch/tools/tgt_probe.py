#!/usr/bin/env python3
"""Measurements behind the K1/K2 findings in PERF.md.

``phases`` (one CUDA card)
    K1's and K2's device ms on 3-chain at B = 512 and 131,072 with
    ``csrc/fused_tgt.cu`` rebuilt with one phase compiled out at a time
    (the weights' staging, the fragment loads, the products, the
    epilogues, the epilogues' work with their wait for the sums kept,
    K2's scratch copies, pass B's products, pass C's two launches), then
    with all of them (the barriers, the table walk and the X_0 / g loads
    left): where the kernels' time goes.  The outputs of a build without
    a phase are wrong; only the times are read.
``ab TREE [TREE ...]`` (one CUDA card)
    One dense train step of ``3-chain_inter`` through K1/K2 (``--kernel
    fused_fwd --fused_backward pallas``; the flagship model, 4
    negatives, Adam) at B = 512 and at B = 131,072, from each checkout
    TREE in turn, each in a process of its own: the median step ms of 20
    timed steps after 3 warm ones (host clock, the loss read each step).
    To compare two commits, unpack both (``git archive``) and pass them
    in turns: parent, change, change, parent.
``emulate`` (CPU)
    The figures ``ops/fused_fwd.py chain_gate`` was derived from: K1/K2's
    plain versions against the same chain in another sum order
    (``_reordered_matmul``: exact sums, rounded once) at d = 128, B = 512
    and 1,000, the 7 structures, seeds 0 to 3, biases 0 or N(0, 0.1);
    then the two negative controls' figures.  Then the figures behind
    ``PARAM_GRAD_MEAN_BY_DEPTH``: the same reordered chain backward of a
    bf16 model mapped through the weight assembly to the parameter
    gradients (``param_figures``), against the plain K2's, worst per
    depth, and the control's (``param_grad_control``) against both the
    limit and the depth tolerance it replaces.

Usage: python3 mpqe_tpu_torch/tools/tgt_probe.py phases
       python3 mpqe_tpu_torch/tools/tgt_probe.py ab runs/parent . . runs/parent
       python3 mpqe_tpu_torch/tools/tgt_probe.py emulate
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

AB_RUN = r"""
import statistics, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.ops import fused_fwd as ff
from mpqe_tpu_torch.queries import STRUCTURES
from mpqe_tpu_torch.train import loop as loop_mod
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
cfg = mpqe_mod.MPQEConfig(**cs.FLAGSHIP)
structure = "3-chain_inter"
spec = STRUCTURES[structure]
for B in (512, 131072):
    tc = loop_mod.TrainConfig(lr=0.01, batch_size=B, n_neg=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = loop_mod.init_train_state(gen, cfg, tc, device=dev)
    step = loop_mod.make_train_step(
        cfg, state.optimizer,
        lambda *a: mpqe_mod.dense_batch_loss_kernel_fused_fwd(
            *a, backward="pallas"))

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
    k1 = ff.fused_tgt_forward.launches
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(state.model, structure, *batch))
        ms.append((time.perf_counter() - t0) * 1e3)
    k1 = ff.fused_tgt_forward.launches - k1
    ms = ms[3:]
    print(f"ab step {structure} B={B}: median_ms={statistics.median(ms):.3f} "
          f"min_ms={min(ms):.3f} max_ms={max(ms):.3f} loss={loss:.6f} "
          f"K1_launches={k1}", flush=True)
    del state, step, batch
    torch.cuda.empty_cache()
"""

# (phase, kernel, text in csrc/fused_tgt.cu, its replacement)
PHASES = (
    ("weight staging", "K1+K2", "    if (s < n_steps) {\n      const int l",
     "    if (false) {\n      const int l"),
    ("fragment loads", "K1+K2", "    load_frags(0, fa[0], fb[0]);\n",
     "    if (false) load_frags(0, fa[0], fb[0]);\n"),
    ("products", "K1+K2",
     "          mma16816(acc[mi][j], fa[ks & 1][mi], fb[ks & 1][j]);",
     "          ;"),
    ("epilogues", "K1+K2",
     "    epilogue(chunk, chunk.x & 15, (chunk.x >> 4) & 1);",
     "    if (false) epilogue(chunk, chunk.x & 15, (chunk.x >> 4) & 1);"),
    # the epilogues' own work out, their wait for every mma kept: each
    # chunk still reads all its sums (never true, never stores)
    ("epilogue work (sums still read)", "K1+K2",
     "    epilogue(chunk, chunk.x & 15, (chunk.x >> 4) & 1);",
     "    {\n      float z = 0.f;\n"
     "      for (int i = 0; i < MW; ++i)\n"
     "        for (int j = 0; j < NW; ++j)\n"
     "          for (int c = 0; c < 4; ++c) z += acc[i][j][c];\n"
     "      if (z == 1.2345e-30f) bw.dbp[threadIdx.x] = z;\n    }"),
    ("scratch copies", "K2",
     "__device__ __forceinline__ void copy_out(const bf16* src, int pitch,\n"
     "                                         bf16* dst, int width, int rows,"
     "\n                                         int q0, int B) {\n",
     "__device__ __forceinline__ void copy_out(const bf16* src, int pitch,\n"
     "                                         bf16* dst, int width, int rows,"
     "\n                                         int q0, int B) {\n"
     "  return;\n"),
    ("pass B products", "K2",
     "          mma16816(acc[mi][j], dfa[ks & 1][mi], dfb[ks & 1][j]);",
     "          ;"),
    ("pass C (dW)", "K2", "  if (i >= a.off[a.L]) return;", "  return;"),
    ("pass C (db)", "K2", "  if (i >= a.db_T) return;", "  return;"),
    ("all but loads and barriers", "K1+K2", None, None),
)


def ab(trees) -> None:
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", AB_RUN], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("ab ")]
        print(f"ab {tree} rc={out.returncode}: " + " | ".join(lines),
              flush=True)
        if out.returncode:
            print(out.stderr[-2000:], flush=True)


def _variant(name: str, source: str, lib0):
    """Build ``source`` with the K1/K2 library's flags and entry points."""
    from mpqe_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR / "tgt_phases"
    d.mkdir(parents=True, exist_ok=True)
    cu, so = d / f"{name}.cu", d / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("mpqe_tgt_forward", "mpqe_tgt_backward", "mpqe_tgt_smem_bytes",
               "mpqe_tgt_max_smem", "mpqe_tgt_k_tile"):
        getattr(lib, fn).argtypes = getattr(lib0, fn).argtypes
        getattr(lib, fn).restype = getattr(lib0, fn).restype
    return lib


def phases() -> None:
    import torch

    import chip_smoke as cs
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import cuda_build
    from mpqe_tpu_torch.ops import fused_fwd as ff

    torch.backends.cuda.matmul.allow_tf32 = False
    source = (cuda_build.CSRC_DIR / "fused_tgt.cu").read_text()
    libs = {"all phases": ff._tgt_kernel()}
    rest = source
    for i, (name, _, old, new) in enumerate(PHASES):
        if old is None:  # every phase above compiled out at once
            libs[name] = _variant(f"v{i}", rest, libs["all phases"])
            continue
        if source.count(old) != 1:
            raise AssertionError(f"phase {name!r} not found in the source")
        rest = rest.replace(old, new)
        libs[f"without {name}"] = _variant(f"v{i}", source.replace(old, new),
                                           libs["all phases"])
    cfg = mpqe_mod.MPQEConfig(**cs.FLAGSHIP)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = mpqe_mod.init_mpqe(gen, cfg, device=dev)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    print(f"phases: {torch.cuda.get_device_name(0)}", flush=True)
    structure = "3-chain"
    blocks = ff.chain_blocks(cfg, structure)
    for B, iters in ((cs.TRAIN_BATCH, 20), (cs.TRAIN_BIG, 5)):
        args = cs.shared_inputs(gen, cfg, structure, B)
        x0, ws, bs, n_a, dp = cs.chain_operands(model, cfg, structure, args)
        g = torch.randn((B, cfg.embed_dim), generator=gen, device=dev)
        for name, lib in libs.items():
            ff._TGT_KERNEL = lib
            with torch.no_grad():
                a = cs.device_ms(lambda: ff._chain_forward(
                    x0, ws, bs, cfg.embed_dim, blocks), iters, flush)
                b = cs.device_ms(lambda: ff._chain_backward(
                    x0, ws, bs, g, n_a, cfg.embed_dim, dp, blocks), iters,
                    flush)
            print(f"phases {structure} B={B:6d} {name:32s} "
                  f"K1_device_ms={a:.4f} K2_device_ms={b:.4f}", flush=True)
        ff._TGT_KERNEL = libs["all phases"]


def emulate() -> None:
    import numpy as np
    import torch

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    torch.set_num_threads(4)
    cfg = mpqe_mod.MPQEConfig(n_entities=5000, n_modes=4, n_rels=266,
                              embed_dim=128, n_layers=3, num_bases=16)
    keys = ("row_max", "row_share", "max", "leaf_max", "leaf_share",
            "leaf_mean")
    worst = {"noise": {}, "zero_block": {}, "anchor_row": {}}
    fails = {"zero_block": 0, "anchor_row": 0}
    cases = 0
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        model = mpqe_mod.init_mpqe(gen, cfg)
        with torch.no_grad():
            for lp in model.layers:
                if seed % 2:
                    lp.bias.normal_(0.0, 0.1, generator=gen)
        for B in (512, 1000):
            for structure in STRUCTURE_NAMES:
                spec = STRUCTURES[structure]
                rng = np.random.default_rng(seed * 7 + B)
                targs = [torch.from_numpy(a) for a in (
                    rng.integers(0, 5000, (B, spec.n_nodes)).astype(np.int32),
                    rng.integers(0, 4, (B, spec.n_nodes)).astype(np.int32),
                    rng.integers(0, 266, (spec.n_edges,)).astype(np.int32),
                    rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(
                        np.float32))]
                g = torch.from_numpy(rng.normal(size=(B, 128)).astype(
                    np.float32))
                blocks = ff.chain_blocks(cfg, structure)
                with torch.no_grad():
                    v_slots, dp, cols, Ws, bs = ff._assemble(
                        model, cfg, structure, *targs, None)
                    x0 = ff._layer0_operand(cols, targs[1], v_slots, cfg, dp)
                    ws = [W.to(torch.bfloat16) for W in Ws]
                    n_a, L = len(cols), len(ws)
                    mm = ff._reordered_matmul
                    kf = ff._chain_forward_plain(x0, ws, bs, 128, mm=mm)
                    da, dws, dbs = ff._chain_backward_plain(
                        x0, ws, bs, g, n_a, 128, dp, mm=mm)
                    dws = [torch.where(blocks.mask(li), w, w.new_zeros(()))
                           for li, w in enumerate(dws)]
                    kb = (da, dws, dbs)
                    for name, x, w in (("noise", x0, ws),
                                       *ff.chain_gate_controls(
                                           x0, ws, blocks, n_a, 128)):
                        pf = ff._chain_forward_plain(x, w, bs, 128)
                        pb = ff._chain_backward_plain(x, w, bs, g, n_a, 128,
                                                      dp)
                        gf = ff.chain_gate(kf, pf, L)
                        gb = ff.chain_gate(kb, pb, L, blocks)
                        if name != "noise":
                            fails[name] += (not gf["ok"]) and (not gb["ok"])
                        elif not (gf["ok"] and gb["ok"]):
                            print(f"emulate: noise fails the gate: "
                                  f"{structure} B={B} seed={seed} {gf} {gb}")
                        side = "L1" if L == 1 else "deep"
                        for gate, pre in ((gf, "K1"), (gb, "K2")):
                            for k in keys:
                                if k in gate:
                                    key = f"{pre} {side} {k}"
                                    worst[name][key] = max(
                                        worst[name].get(key, 0.0), gate[k])
                cases += 1
    print(f"emulate: {cases} cases (7 structures x B in 512, 1000 x seeds "
          f"0-3; odd seeds with biases N(0, 0.1)); d = 128, 16 bases")
    for key, v in sorted(worst["noise"].items()):
        print(f"emulate: reordering {key:20s} worst {v:.3e}")
    for name in ("zero_block", "anchor_row"):
        print(f"emulate: control {name}: fails K1 and K2 in "
              f"{fails[name]} of {cases} cases")


def param_figures(model, cfg, structure: str, B: int, seed: int):
    """(reordered, control) figures of one case: ``param_grad_mean_err``
    of the parameter gradients of the chain backward in another sum order
    (exact, then rounded; dW_l kept on the listed blocks) against the
    plain K2's, and of ``param_grad_control`` of them."""
    import numpy as np
    import torch

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURES

    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed * 7 + B)
    targs = [torch.from_numpy(a) for a in (
        rng.integers(0, cfg.n_entities, (B, spec.n_nodes)).astype(np.int32),
        rng.integers(0, cfg.n_modes, (B, spec.n_nodes)).astype(np.int32),
        rng.integers(0, cfg.n_rels, (spec.n_edges,)).astype(np.int32),
        rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(np.float32))]
    g = torch.from_numpy(rng.normal(size=(B, cfg.embed_dim)).astype(
        np.float32)).to(torch.bfloat16)
    blocks = ff.chain_blocks(cfg, structure)

    def reordered(x0, ws, bs, g, n_a, d, dp):
        da, dws, dbs = ff._chain_backward_plain(x0, ws, bs, g, n_a, d, dp,
                                                mm=ff._reordered_matmul)
        return da, [torch.where(blocks.mask(li), w, w.new_zeros(()))
                    for li, w in enumerate(dws)], dbs

    got, _, _ = ff._backward_with(reordered, model, cfg, structure, *targs,
                                  None, g, torch.bfloat16)
    want, _, _ = ff._backward_with(ff._chain_backward_plain, model, cfg,
                                   structure, *targs, None, g,
                                   torch.bfloat16)
    depth = mpqe_mod.num_steps(cfg, structure)
    return (ff.param_grad_mean_err(got, want), ff.param_grad_mean_err(
        ff.param_grad_control(got, want, depth), want))


def emulate_params() -> None:
    import torch

    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    old = {1: 3e-2, 2: 8e-2, 3: 2.5e-1}  # the depth tolerance replaced
    cfg = mpqe_mod.MPQEConfig(n_entities=5000, n_modes=4, n_rels=266,
                              embed_dim=128, n_layers=3, num_bases=16,
                              dtype=torch.bfloat16)
    worst, ctrl = {}, {}
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        model = mpqe_mod.init_mpqe(gen, cfg)
        with torch.no_grad():
            for lp in model.layers:
                if seed % 2:
                    lp.bias.normal_(0.0, 0.1, generator=gen)
        for B in (512, 1000):
            for structure in STRUCTURE_NAMES:
                depth = mpqe_mod.num_steps(cfg, structure)
                e, c = param_figures(model, cfg, structure, B, seed)
                worst[depth] = max(worst.get(depth, 0.0), e)
                lo, hi = ctrl.get(depth, (1.0, 0.0))
                ctrl[depth] = (min(lo, c), max(hi, c))
    for depth in sorted(worst):
        lim = ff.PARAM_GRAD_MEAN_BY_DEPTH[depth]
        print(f"emulate params depth {depth}: reordering worst "
              f"{worst[depth]:.3e} (limit {lim:g}); control "
              f"{ctrl[depth][0]:.3e} to {ctrl[depth][1]:.3e} (fails the limit: "
              f"{ctrl[depth][0] > lim}; passes the old {old[depth]:g}: "
              f"{ctrl[depth][1] <= old[depth]})", flush=True)


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["ab"] and len(argv) > 1:
        ab(argv[1:])
    elif argv == ["phases"]:
        phases()
    elif argv == ["emulate"]:
        emulate()
        emulate_params()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
