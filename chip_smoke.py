#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpqe_tpu_torch``) on one GPU.

Drives the serving path, the per-formula evaluation through the sparse
encoder, the full ranking, the dense training path, the sparse training
path (``--kernel fused`` and ``--kernel blocked``) and the training
through the edge-partitioned halo layers (``--parallel halo_ring`` /
``halo_gather``) at the flagship width (d = 128, 3 R-GCN layers, TGT
readout, 16 bases or full per-relation weights, 266 relations, 4 modes,
1,000,000 entities; random weights from a seed) and checks every
hand-written kernel on them.  The seven kernel libraries build in
parallel (one nvcc each), then:

1. ``kernel.fused_multi``: K3 (``csrc/fused_multi.cu``, products on the
   tensor cores, one launch per layer) for all 7 structures at B = 256
   and at a ragged B = 1000: vs its plain PyTorch version under
   ``ops/fused_fwd.py multi_gate`` (the output under ``chain_gate``:
   one-layer structures <= 1e-4 max|diff| / max|ref|, deeper rows <=
   2e-3, at most 10 % above 1e-4; and layer by layer from the kernel's
   own activations: each element within one bf16 step, at most 0.1 %
   moved, the last layer's rows <= 1e-4 of their own max), both
   controls of ``multi_gate_controls`` (query 0's relation on one edge
   changed, its anchor row moved 8 bf16 steps) failing it, a repeat
   launch through the serving path bit-equal, and vs the float32
   ``encode_dense_multi`` (<= 3e-2,
   the bf16 envelope); times kernel (CUDA events, L2 flushed before each
   call as a serving dispatch finds it) and its kernels' device time
   (profiler), the plain version and, as a yardstick only, the same
   products through ``torch.matmul``, beside the card's bound.
2. ``serve``: a ``QueryServer`` on the card answers a stream of sampled
   queries over all 7 structures; K3's launch count must equal one per
   layer of each eligible dispatch, and one dispatch per structure is
   recomputed: the serving layers from the kernel's own query vectors
   (the same scores, within 1e-4), and those vectors within K3's gate of
   the plain version.
3. ``kernel.fused_tgt`` / ``kernel.fused_tgt_backward``: K1 and K2
   (``csrc/fused_tgt.cu``, tensor cores, only the listed blocks of W_l)
   for all 7 structures at B = 512 and a ragged B = 1000: K1 and K2 (dA,
   every dW_l on the listed blocks and 0 off them, db_l) vs their plain
   versions under ``ops/fused_fwd.py chain_gate``, both negative controls
   (one block of W_0 zeroed, one anchor row moved 8 bf16 steps) failing
   it, a repeat launch bit-equal; K1 vs the f32 ``encode_dense`` (<=
   3e-2); K2's parameter gradients (through the differentiable weight
   assembly) vs autograd of the f32 encoder within the reference's depth
   tolerances.  Times both kernels at B = 512 and
   B = 131,072 (L2 flushed before each launch: the optimizer update
   between two steps streams GBs), CUDA events around the wrapper and the
   kernels' own device time (torch.profiler), beside the bound and, as a
   yardstick only, the same per-layer products through ``torch.matmul``.
4. ``kernel.rgcn_fused``: K5a (16-basis layer) and K5b (full-weight
   layer) of ``csrc/rgcn_fused.cu`` (tensor cores, split TF32) on the
   ``template_chunked`` layouts of the 7 structures at B = 512 and
   131,072 and on ``chunk_by_relation`` of a general graph (65,536 nodes,
   1,048,576 random typed edges, padded chunks): each vs its plain
   version (<= 1e-4) and the f32 batched oracle (<= 1e-5), a repeat
   launch bit-equal, the negative control (one chunk's coefficients or
   relation changed in the plain version) failing the plain gate, the
   transposed-weight read (the backward's dxs) vs the plain version on a
   transposed copy (<= 1e-4); times (CUDA events and profiler, L2
   flushed) beside the bound (split-TF32 route; the f32-pipe route's
   printed beside it), the plain version and the ``torch.bmm`` yardstick
   on the per-chunk weights.
5. ``kernel.rgcn_blocked``: K6a (forward and transpose layout) and K6b
   of ``csrc/rgcn_blocked.cu`` (tensor cores) on ``template_blocked`` for
   the 7 structures at both batches and ``bucket_edges_blocked`` of the
   same general graph: K6a within ``blocked_error_bound`` of its plain
   version, K6b under ``k6b_gate`` (dbasis <= 1e-4, each s_eb the plain
   one or its bf16 neighbour, at most 1 % off it, dcoeff the ordered sum
   of the kernel's own s_eb), each negative control failing (one edge, or
   one relation, removed from the plain version), a repeat launch
   bit-equal, K6a vs the f32 twin (<= 3e-2, train batch only); the edge
   lists' build time (once per batch) apart; times as for K5 beside a
   cuBLAS yardstick (the bf16 products ``xs @ [V_0 .. V_Bb]``, and for
   K6b also ``xs^T rhs``).
6. ``kernel.segment``: the K4 layout kernel and K4a / K4b
   (``csrc/segment.cu``) on the reference's chip-check shape (E = 1,000,
   S = 64), each structure's destination sum at B = 1,024 (the bucket of
   ``evaluate``'s 1,000 queries per formula) and the cap (E = 2^20, S =
   8,192): the layout equal to the plain layout and to a repeat launch;
   K4a and K4b, with the layout built in the call and given, equal to
   each other and to their plain versions (K4a <= 1e-4, K4b equal), K4a
   vs an f64 oracle (<= 1e-5), dropped out-of-range rows and empty
   segments (0, -1e30); times of each kernel with its layout built and
   given and of the layout alone, beside the bound, the plain version
   and one ``index_add_`` / ``scatter_reduce`` / stable ``argsort`` as
   the yardstick.
7. ``kernel.sddmm``: K7 (``csrc/sddmm.cu``) on N = 512 / E = 2,048, the
   final-layer node embeddings of the B = 1,024 batches over their own
   edges (K7's drive: it has no caller in the package) and N = 8,191 /
   E = 2^20: equal to its plain version (the same sum order) and within
   1e-5 of an f64 oracle, out-of-range endpoints scoring 0; times beside
   the bound, the plain version and ``torch.sparse.sampled_addmm`` as
   the yardstick, with its CSR pattern built outside the timed call and
   inside it.
8. ``kernel.ring``: K8 (``csrc/ring.cu``) over rings of P parts on one
   card: the general graph at P = 2, 3, 4, 8 and each structure's
   template layout at B = 512 on 4 parts, launched P times per layer
   call (counted from 0 over these 11 calls); each vs its plain version
   (equal), the port's ``rgcn_ring_halo`` and the single-device
   ``rgcn_sparse`` (<= 1e-5), and again with every aggregate delayed by
   ``torch.cuda._sleep`` (equal: the ack events hold the copies back);
   times (CUDA events, L2 flushed; K8's device time and the copy
   stream's from the profiler) beside the bound and the plain version.
9. ``eval.sparse``: ``evaluate`` on sampled validation queries through
   an adapter (``dense_to_sparse``, then ``encode_sparse`` with the
   ``"pallas"`` segment backend) for the flagship model (K4a) and a
   max-readout model (K4a, K4b): K4 launches equal to the expected
   counts (the layout once per encode for the destination sums, once
   more for a sum, mlp or max readout), per-structure AUC and APR / 100
   within 1e-3 of ``evaluate`` through the f32 ``encode_dense``, one
   formula per structure bit-equal through the plain K4; then 20 dense
   train steps with one validation round through
   ``run_train(eval_encode_fn=...)``.
10. ``eval.ranking``: ``full_ranking`` over the same queries against all
   1M entities; one structure's ranks recomputed by ``torch.matmul`` and
   a per-row count give the same metrics.
11. ``train``: ``run_train`` on the card with ``--kernel fused_fwd
   --fused_backward pallas`` (batch 512, 4 negatives, Adam lr 0.01, every
   structure from the first step) and one validation round through K3;
   K1 and K2 launch once per step, K3 during validation, every loss is
   finite, and one step repeated from the same state through the plain
   versions gives the same loss (<= 1e-4) and gradients (per leaf
   mean|diff| / mean|ref| <= 1e-4, the max printed beside it).  Step time p50/p95, real
   queries/s (and padded rows/s) and a ``torch.profiler`` account of 10
   steps.
12. ``train.fused``, ``train.fused_full``, ``train.blocked``:
   ``run_train`` through the sparse path (``--kernel fused`` with a
   16-basis and a full-weight model, ``--kernel blocked``), 50 steps
   each: launch counts equal to 2 K5 (or 2 K6a and 1 K6b) per layer of
   every step, finite losses, one step per structure recomputed through
   the plain versions (same loss and gradients, <= 1e-4: the segment
   sums use index_add_; ``train.blocked``'s gradients per leaf in
   mean|diff| / mean|ref|), step p50/p95 and a profile of 10 steps.
13. ``halo.train.ring``, ``halo.train.gather``: ``run_train`` through
   ``make_halo_train_step`` (``rgcn_ring_halo`` / ``rgcn_dst_partitioned``)
   on 4 parts of the card, 20 steps each: finite losses, step p50/p95
   and real queries/s, one batch per structure whose halo loss and
   gradients equal ``dense_batch_loss``'s from the same state (<= 1e-5),
   and a profile of 10 steps.
14. ``train.cli``: ``python -m mpqe_tpu_torch.train`` as a subprocess on
   a small KG with ``--kernel fused_fwd``, with ``--kernel blocked`` and
   with ``--parallel halo_ring`` (the default mesh: one part on one
   card); the final line and run dir of each; ``eval.cli``: ``python -m
   mpqe_tpu_torch.evaluate --run_dir <the first run> --ranking``;
   ``serve.cli``: ``python -m mpqe_tpu_torch.serve --run_dir <the first
   run>`` over all 7 structures.

Prints the card's name and power limit first, then one line per check,
a JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``.  Any failed check raises and the exit code is nonzero.  Needs
one CUDA card and the repository's sources (it builds the kernels).

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL_PLAIN = 1e-4  # kernel vs its plain version: same function, sum order
TOL_F32 = 3e-2  # kernel vs the float32 encoder: bf16 operands
TOL_ORACLE = 1e-5  # K5 vs the f32 batched oracle: f32 both, sum order
TOL_SCORE = 1e-4  # served top-k scores vs the plain recomputation
# K2's parameter gradients vs autograd of the f32 encoder, by depth: the
# reference's own tolerances (tests/test_pallas_fused_fwd.py:261), held
# per leaf to mean|diff| / mean|ref|, the form the reference's chip check
# uses (tools/tpu_smoke.py:185-190).  Its max-element form holds at the
# reference's test width (d = 16, B = 20) but not here: ReLU masks near
# zero flip between the f32 and the bf16 forward, and at d = 128 and
# B = 512 or 1000 a flip moves single elements of layer-0 leaves by up to
# 0.14 of the leaf's max (the reference measured ~0.15 between any two
# precisions, mpqe_tpu/ops/pallas_fused_fwd.py:549-557).  The max-element
# figure is printed beside the gate.
TOL_GRAD_BY_DEPTH = {1: 3e-2, 2: 8e-2, 3: 2.5e-1}
H100_BF16_FLOPS = 989e12  # dense tensor-core peak (H100 SXM data sheet)
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak (the same sheet)
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
L2_FLUSH_BYTES = 512 << 20  # > the 50 MB L2
PROFILE_TRIES = 3

FLAGSHIP = dict(n_entities=1_000_000, n_modes=4, n_rels=266, embed_dim=128,
                n_layers=3, num_bases=16)
KG = dict(n_entities=1_000_000, n_modes=4, n_base_rels=133,
          n_triples=1_000_000, seed=0)
BATCH = 256  # queries per dispatch: the server's cap at 1M entities
RAGGED = 1000
K = 10
ITERS, PLAIN_ITERS = 50, 10  # timed launches per structure
TRAIN_BATCH = 512  # train.py's default batch
TRAIN_BIG = 131_072  # the repo's flagship train batch (bench.py:42)
BIG_ITERS = 5
TRAIN_STEPS = 100
PROFILE_STEPS = 10
SPARSE_STEPS = 50  # train steps of each sparse-path run
PLAIN_ITERS_K6 = 3  # timed plain K6 calls at the train batch
# the reference's kernel-bench graph (pallas_rgcn_blocked.py:57-58)
GENERAL_NODES, GENERAL_EDGES = 65_536, 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls, each after the L2
    is flushed, as a serving dispatch finds it (the rank matmul between
    two encodes streams a GiB).  CUDA events bracket each call only; the
    flush gives the host time to enqueue the call before the device
    reaches it."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


# every kernel of csrc/fused_tgt.cu: tgt_mma_chain_kernel (K1; K2's pass
# A), tgt_mma_dw_kernel, tgt_mma_reduce_kernel, tgt_mma_reduce_db_kernel
TGT_KERNELS = ("tgt_mma_",)


def device_ms(fn, iters: int, flush: torch.Tensor,
              names=TGT_KERNELS, per_call: int = 1) -> float:
    """Mean device ms per ``fn()`` call of the kernels named in ``names``
    alone (torch.profiler; by default those of ``csrc/fused_tgt.cu``),
    each call after an L2 flush as in :func:`time_ms`: the kernels' own
    time, without the wrapper's host work or its other device work (K2's
    weight transposes, K6's bf16 casts).  The profile has a warmup step
    of the same calls, whose events it drops: late in a long run a
    profile without one lost the first 4 of its calls (46 of 50 launches
    of a small kernel recorded, 1 of 5 of a large one).  A profile that
    records fewer device events of those kernels than calls (each call
    launches at least one) is taken again, up to PROFILE_TRIES times in
    all; if none is whole, the fullest is returned and the log says so.
    ``per_call``: the launches of those kernels one call makes at least
    (K5a: its prologue and its messages), so that a profile that lost
    calls is not taken for a whole one."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)  # (launches recorded, device us)
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):  # the warmup step, then the recorded one
                for _ in range(iters):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.key for k in names)]
        got = (sum(e.count for e in rows),
               sum(e.device_time_total for e in rows))
        if got[0] >= iters * per_call and got[1] > 0:
            return got[1] / iters / 1e3
        log(f"device_ms: profile {attempt + 1} recorded {got[0]} launches "
            f"of {names} in {iters} calls")
        best = max(best, got)
    if best[1] == 0:
        raise AssertionError(f"the profiler saw none of {names} in "
                             f"{PROFILE_TRIES} profiles")
    log(f"device_ms: incomplete, {best[0]} launches of {names} recorded in "
        f"{iters} calls")
    return best[1] / iters / 1e3


def k3_work(cfg, structure: str, node_entity, node_mode, edge_rel_q):
    """(bytes, bf16 tensor-core FLOPs, f32 FLOPs) one K3 launch needs for
    these inputs.  Bytes: each input read once and the output written
    once, counting of the tables only what this run's data selects (the
    distinct anchor rows of the entity table; per layer the bias, the
    coefficient rows of the distinct relations, ``w_self`` only where
    some slot's self term is a product, the bases only where some
    message source is, and the premultiplied layer-0 variable rows of the
    distinct modes otherwise).  bf16 FLOPs: the products, once per
    source slot.  f32 FLOPs: the coefficient combination, norm and sums."""
    from mpqe_tpu_torch.ops.fused_fwd import _plan

    spec, steps, plan, a_slots, v_slots = _plan(cfg, structure)
    B, d, nb = node_entity.shape[0], cfg.embed_dim, cfg.num_bases

    def distinct(t, cols):
        return torch.unique(t[:, list(cols)]).numel() if cols else 0

    nbytes = (distinct(node_entity, a_slots) * d * 4
              + 2 * B * spec.n_nodes * 4 + 2 * B * spec.n_edges * 4
              + B * d * 4)
    var_modes = distinct(node_mode, v_slots)
    mma = f32 = 0
    for li, (_, out_slots, edges) in enumerate(plan):
        var0 = set() if li else set(v_slots)
        self_mm = [s for s in out_slots if s not in var0]
        srcs = {spec.edge_src[j] for j in edges}
        msg_mm = [s for s in srcs if s not in var0]
        nbytes += d * 4 + distinct(edge_rel_q, edges) * nb * 4
        nbytes += (d * d * 2 if self_mm else 0) + (
            nb * d * d * 2 if msg_mm else 0)
        if len(self_mm) < len(out_slots):
            nbytes += var_modes * d * 2
        if len(msg_mm) < len(srcs):
            nbytes += var_modes * nb * d * 2
        mma += 2 * d * d * len(self_mm) + 2 * d * nb * d * len(msg_mm)
        f32 += len(edges) * (2 * nb * d + 2 * d) + len(out_slots) * 2 * d
    return nbytes, B * mma, B * f32


def bound_times(work) -> tuple:
    """(ms for the bytes, ms for the operations) on the card's peaks; the
    bf16 tensor-core and f32 pipes run side by side, so the operations
    take the longer of the two.  A fourth entry (K5) is the TF32 FLOP of
    another route to the same f32 products (split TF32 on the tensor
    cores): the f32 FLOP take the faster of the two routes."""
    nbytes, mma, f32 = work[:3]
    t_f32 = f32 / H100_F32_FLOPS
    if len(work) > 3:
        t_f32 = min(t_f32, work[3] / H100_TF32_FLOPS)
    return (nbytes / H100_BYTES_PER_S * 1e3,
            max(mma / H100_BF16_FLOPS, t_f32) * 1e3)


def random_inputs(gen: torch.Generator, cfg, structure: str, B: int, device):
    from mpqe_tpu_torch.queries import STRUCTURES

    spec = STRUCTURES[structure]

    def ints(high, cols):
        return torch.randint(0, high, (B, cols), generator=gen,
                             device=gen.device, dtype=torch.int32).to(device)

    ne = ints(cfg.n_entities, spec.n_nodes)
    nm = ints(cfg.n_modes, spec.n_nodes)
    er = ints(cfg.n_rels, spec.n_edges)
    en = (0.5 + torch.rand((B, spec.n_edges), generator=gen,
                           device=gen.device)).to(device)
    return ne, nm, er, en


def library_multi(cfg, ops, structure: str, B: int, gen):
    """K3's yardstick: the same products through ``torch.matmul`` on bf16
    operands, per layer the wide ``x @ [d, Bb d]`` for each message
    source that is a product and ``x @ w_self`` for each self term that is
    one (never called by the port)."""
    from mpqe_tpu_torch.ops.fused_fwd import _plan

    spec, _, plan, _, _ = _plan(cfg, structure)
    anchors = set(spec.anchor_slots)
    pairs = []
    for li, (_, out_slots, edges) in enumerate(plan):
        srcs = {spec.edge_src[j] for j in edges}
        for w, slots in ((ops.vw[li], srcs), (ops.w_self[li], out_slots)):
            for s in slots:
                if li > 0 or s in anchors:
                    x = torch.randn((B, ops.d_pad), generator=gen,
                                    device=gen.device).to(torch.bfloat16)
                    pairs.append((x, w))
    return lambda: [torch.matmul(x, w) for x, w in pairs]


K3_KERNELS = ("fused_multi_layer",)


def phase_kernel(model, cfg, ops, device, gen, flush):
    """K3 against its plain version under ``multi_gate`` (its products run
    on the tensor cores), both controls of ``multi_gate_controls`` (on
    query 0) failing the gate and a repeat launch through the serving
    path bit-equal, and against the f32 encoder; times at the serving
    batch.  Returns the kernel's JSON fields (launches excluded)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    max_abs = 0.0
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for structure in STRUCTURE_NAMES:
        L = mpqe_mod.num_steps(cfg, structure)
        for B in (BATCH, RAGGED):
            args = random_inputs(gen, cfg, structure, B, device)
            with torch.inference_mode():
                # every layer's activations kept, for the layer gate
                got, acts = ff.fused_tgt_forward_multi_layers(
                    model, cfg, structure, *args, operands=ops)
                again = ff.fused_tgt_forward_multi(model, cfg, structure,
                                                   *args, operands=ops)
                plain = ff.fused_tgt_forward_multi_reference(
                    model, cfg, structure, *args, operands=ops)
                f32 = mpqe_mod.encode_dense_multi(model, cfg, structure,
                                                  *args)
                gate = ff.multi_gate(cfg, structure, ops, args, got, acts,
                                     want=plain)
                controls = {name: ff.multi_gate(
                    cfg, structure, o2, (ne, args[1], er, args[3]), got,
                    acts) for name, o2, ne, er in ff.multi_gate_controls(
                        cfg, structure, ops, args[0], args[2])}
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{structure} B={B}: non-finite output")
            fails = all(not c["ok"] for c in controls.values())
            repeat = bool(torch.equal(got, again))
            e_f32 = rel_err(got, f32)
            max_abs = max(max_abs, float((got - plain).abs().max()))
            ctl = " ".join(f"{name}: steps={c['steps']:.0f} "
                           f"last={c['last']:.3e}"
                           for name, c in controls.items())
            line = (f"kernel.fused_multi {structure:14s} B={B:5d} "
                    f"gate_ok={gate['ok']} ({gate_text(gate)}) "
                    f"controls_fail={fails} (query 0: {ctl}) "
                    f"repeat_equal={repeat} err_vs_f32={e_f32:.3e}")
            if not gate["ok"] or not fails or not repeat or e_f32 > TOL_F32:
                log(line + " FAIL")
                raise AssertionError(line)
            if B == BATCH:
                def kfn():
                    ff.fused_tgt_forward_multi(model, cfg, structure, *args,
                                               operands=ops)

                with torch.inference_mode():
                    ms = time_ms(kfn, ITERS, flush)
                    k_ms = device_ms(kfn, ITERS, flush, K3_KERNELS,
                                     per_call=L)
                    plain_ms = time_ms(
                        lambda: ff.fused_tgt_forward_multi_reference(
                            model, cfg, structure, *args, operands=ops),
                        PLAIN_ITERS, flush)
                    lib_ms = time_ms(library_multi(cfg, ops, structure, B,
                                                   gen), ITERS, flush)
                work = k3_work(cfg, structure, args[0], args[1], args[2])
                t_bytes, t_ops = bound_times(work)
                b_by = "bytes" if t_bytes >= t_ops else "operations"
                for k, v in (("ms", ms), ("device_ms", k_ms),
                             ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("bound_ms", max(t_bytes, t_ops)),
                             ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
                    tot[k] += v
                line += (f" kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
                         f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                         f"launches_per_call={L} blocks_per_launch="
                         f"{ff.multi_blocks(B, ops.d_pad)} "
                         f"bound_ms={max(t_bytes, t_ops):.6f} ({b_by}: "
                         f"{work[0]} B, {work[1]} bf16 FLOP, "
                         f"{work[2]} f32 FLOP)")
            log(line)
    by = "bytes" if tot.pop("bytes_ms") >= tot.pop("ops_ms") else \
        "operations"
    dev_ms = tot.pop("device_ms")
    log(f"kernel.fused_multi sum of 7 at B={BATCH}: kernel_ms={tot['ms']:.4f} "
        f"device_ms={dev_ms:.4f} plain_ms={tot['plain_ms']:.4f} "
        f"library_ms={tot['library_ms']:.4f} "
        f"bound_ms={tot['bound_ms']:.6f} ({by})")
    return {"max_abs_err": max_abs, **tot, "bound_by": by}


def sample_stream(kg, seed: int = 123):
    """Requests over all 7 structures: 4 single-structure requests of
    BATCH queries per structure (shuffled), then 4 requests of BATCH
    queries drawn across every structure."""
    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    sampler = QuerySampler(kg, seed=seed)
    batch = BATCH
    pools = {s: sampler.sample_queries(s, batch, n_neg=1)
             for s in STRUCTURE_NAMES}
    rng = np.random.default_rng(0)
    order = [s for s in STRUCTURE_NAMES for _ in range(4)]
    rng.shuffle(order)
    single = [[pools[s][int(i)] for i in rng.integers(0, batch, batch)]
              for s in order]
    union = [q for s in STRUCTURE_NAMES for q in pools[s]]
    mixed = [[union[int(i)] for i in rng.integers(0, len(union), batch)]
             for _ in range(4)]
    return single, mixed


def check_answers(server, req, answers, k: int) -> None:
    """Shape, ids in range, right mode unless -inf, scores non-increasing."""
    mode = server.entity_mode
    for q, a in zip(req, answers):
        if a.entity_ids.shape != (k,) or a.scores.shape != (k,):
            raise AssertionError(f"answer shape {a.entity_ids.shape}")
        if np.isnan(a.scores).any() or np.isposinf(a.scores).any():
            raise AssertionError(f"bad scores {a.scores}")
        ids = a.entity_ids
        if ids.min() < 0 or ids.max() >= mode.shape[0]:
            raise AssertionError(f"id out of range {ids}")
        real = np.isfinite(a.scores)
        if (mode[ids[real]] != q.formula.target_mode).any():
            raise AssertionError("a returned entity has the wrong mode")
        if (np.diff(a.scores) > 0).any():
            raise AssertionError("scores are not sorted")


def recheck_dispatch(server, model, cfg, ops, structure, req, answers):
    """Recompute one dispatch on the card, holding two things apart: the
    serving layers (normalize, the rank GEMM through ``torch.matmul``, the
    mode mask, ``top_k``) from the kernel's own query vectors, where every
    served score agrees with the recomputed score of the same id and no
    served id falls below the recomputed k-th score (ties may swap only
    within the tolerance); and the kernel's vectors, within K3's gate
    (``multi_gate``) of the plain K3 version."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.serve import top_k

    _, *arrays = server._pack(req)
    ne, nm, er, en, tm = [torch.from_numpy(a).to(server.device)
                          for a in arrays]
    with torch.inference_mode():
        qk, acts = ff.fused_tgt_forward_multi_layers(
            model, cfg, structure, ne, nm, er, en, operands=ops)
        qp = ff.fused_tgt_forward_multi_reference(model, cfg, structure, ne,
                                                  nm, er, en, operands=ops)
        gate = ff.multi_gate(cfg, structure, ops, (ne, nm, er, en), qk, acts,
                             want=qp)
        q = mpqe_mod._l2_normalize(qk)
        full = torch.matmul(q, server._ent_norm_t)
        full.masked_fill_(server._mode_dev[None, :] != tm[:, None],
                          float("-inf"))
        ref_vals, _ = top_k(full, K)
    n = len(req)
    full = full[:n]
    ids = torch.from_numpy(np.stack([a.entity_ids for a in answers])).long()
    got = torch.from_numpy(np.stack([a.scores for a in answers]))
    ref_at = full.gather(1, ids.to(full.device)).cpu()
    ref_kth = ref_vals[:n, -1:].cpu()
    finite = torch.isfinite(ref_at)
    err = float((got - ref_at)[finite].abs().max()) if finite.any() else 0.0
    worst = float((ref_kth - ref_at).clamp(min=0)[finite].max()) \
        if finite.any() else 0.0
    same_inf = bool((torch.isfinite(got) == finite).all())
    line = (f"serve.recheck {structure:14s} n={n} score_err={err:.3e} "
            f"below_kth={worst:.3e} k3_gate_ok={gate['ok']} "
            f"({gate_text(gate)})")
    log(line)
    if err > TOL_SCORE or worst > TOL_SCORE or not same_inf or \
            not gate["ok"]:
        raise AssertionError(line)


def phase_serve(model, cfg, ops, kg, device):
    """Serve the sampled stream; returns K3 launches in the stream."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.serve import QueryServer

    t0 = time.perf_counter()
    server = QueryServer(model, cfg, kg.entity_mode, device=device)
    server.warmup(STRUCTURE_NAMES, batch=BATCH, k=K)
    log(f"setup: server + warmup {time.perf_counter() - t0:.2f} s "
        f"(max_batch={server.max_batch})")
    t0 = time.perf_counter()
    single, mixed = sample_stream(kg)
    log(f"setup: sampled {sum(map(len, single + mixed))} queries "
        f"{time.perf_counter() - t0:.2f} s")

    expected = dispatches = 0  # K3 launches: one per layer of a dispatch
    for req in single + mixed:
        for s in STRUCTURE_NAMES:
            n = sum(q.formula.structure == s for q in req)
            if n and mpqe_mod.multi_kernel_eligible(cfg, s):
                dispatches += -(-n // server.max_batch)
                expected += -(-n // server.max_batch) * mpqe_mod.num_steps(
                    cfg, s)
    ff.fused_tgt_forward_multi.launches = 0
    lat = {"single": [], "mixed": []}
    served = []
    for kind, reqs in (("single", single), ("mixed", mixed)):
        for req in reqs:
            t0 = time.perf_counter()
            answers = server.answer(req, k=K)
            lat[kind].append((time.perf_counter() - t0) * 1e3)
            served.append((req, answers))
    launches = ff.fused_tgt_forward_multi.launches
    log(f"serve: K3 launches {launches}, expected {expected} (one per "
        f"layer of {dispatches} eligible dispatches)")
    if launches == 0 or launches != expected:
        raise AssertionError(f"K3 launches {launches} != {expected}")

    for req, answers in served:
        check_answers(server, req, answers, K)
    seen = set()
    for req, answers in served[:len(single)]:
        s = req[0].formula.structure
        if s not in seen:
            seen.add(s)
            recheck_dispatch(server, model, cfg, ops, s, req, answers)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    for kind, ms in lat.items():
        ms = np.asarray(ms)
        log(f"serve.{kind}: {len(ms)} requests of {BATCH} queries on {name}: "
            f"latency_ms_p50={np.percentile(ms, 50):.3f} "
            f"latency_ms_p95={np.percentile(ms, 95):.3f} "
            f"queries_per_s={len(ms) * BATCH / ms.sum() * 1e3:.1f}")
    reqs = [req for req, _ in served[:7]]
    profile_device(f"serve.profile ({len(reqs)} requests)",
                   lambda: [server.answer(r, k=K) for r in reqs])
    return launches


def shared_inputs(gen: torch.Generator, cfg, structure: str, B: int):
    """One formula's batch on the generator's device: per-query entities
    and modes, shared relations and edge norms."""
    from mpqe_tpu_torch.queries import STRUCTURES

    spec = STRUCTURES[structure]
    dev = gen.device

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    return (ints(cfg.n_entities, (B, spec.n_nodes)),
            ints(cfg.n_modes, (B, spec.n_nodes)),
            ints(cfg.n_rels, (spec.n_edges,)),
            0.5 + torch.rand((spec.n_edges,), generator=gen, device=dev))


def chain_operands(model, cfg, structure: str, args):
    """K1/K2's operands for a batch: (x0, ws, bs, n_anchor_cols, d_pad)."""
    from mpqe_tpu_torch.ops import fused_fwd as ff

    with torch.no_grad():
        v_slots, d_pad, cols, Ws, bs = ff._assemble(model, cfg, structure,
                                                    *args, None)
        x0 = ff._layer0_operand(cols, args[1], v_slots, cfg, d_pad)
        ws = [W.to(torch.bfloat16).contiguous() for W in Ws]
        bs = [b.contiguous() for b in bs]
    return x0, ws, bs, len(cols), d_pad


def chain_work(cfg, structure: str, B: int, backward: bool) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) one K1 (or K2) launch needs for a
    batch of B rows: the function's work, not that of the dense operands
    the wrapper builds.  Per layer, each distinct (source slot, output
    slot) pair of ``_layer_matrices`` whose source is an anchor or an
    activation is one nonzero d x d block of W_l, a product of 2 B d^2
    bf16 FLOP; a pair whose source is a layer-0 variable selects one of
    n_modes premultiplied rows by mode id and adds it (B d f32 FLOP); the
    zero blocks of W_l count nothing.  Bytes, each input read once and
    each output written once: the anchor rows in bf16 (B d per anchor
    slot) and one int32 mode id per variable slot and row (as K3's count;
    not the bf16 one-hot block the wrapper builds), the nonzero blocks
    and variable rows of W_l in bf16, the bias in f32, and the output
    (K1) or g read and dA, dW, db written (K2), f32.  K2's products: the
    recompute of layers 0..L-2, then dW and dX over the same blocks; its
    f32 FLOP are the db sums and the variable rows' dW."""
    from mpqe_tpu_torch.ops.fused_fwd import _plan

    spec, _, plan, a_slots, v_slots = _plan(cfg, structure)
    d, m = cfg.embed_dim, cfg.n_modes
    blocks, var_rows, outs = [], 0, 0
    for li, (_, out_slots, edges) in enumerate(plan):
        var0 = set(v_slots) if li == 0 else set()
        pairs = {(s, s) for s in out_slots} | {
            (spec.edge_src[j], spec.edge_dst[j]) for j in edges}
        blocks.append(sum(src not in var0 for src, _ in pairs))
        var_rows += sum(src in var0 for src, _ in pairs)
        outs += len(out_slots)
    nnz = sum(blocks)
    params = nnz * d * d + var_rows * m * d  # nonzero entries of the W_l
    nbytes = (B * len(a_slots) * d * 2 + B * len(v_slots) * 4
              + params * 2 + outs * d * 4 + B * d * 4)
    f32 = B * d * (outs + var_rows)
    if not backward:
        return nbytes, 2 * B * d * d * nnz, f32
    nbytes += B * len(a_slots) * d * 4 + (params + outs * d) * 4
    return nbytes, 2 * B * d * d * (2 * nnz + sum(blocks[:-1])), f32


def library_chain(x0, ws, backward: bool, gen):
    """The yardstick: the same per-layer products through
    ``torch.matmul`` on bf16 operands (never called by the port)."""
    xs, x = [], x0
    with torch.no_grad():
        for w in ws:
            xs.append(x)
            x = torch.relu(torch.matmul(x, w))
    if not backward:
        return lambda: [torch.matmul(a, w) for a, w in zip(xs, ws)]
    gs = [torch.randn((x0.shape[0], w.shape[1]), generator=gen,
                      device=gen.device).to(torch.bfloat16) for w in ws]

    def fn():
        for a, w, g in zip(xs, ws, gs):
            torch.matmul(a, w)
            torch.matmul(a.t(), g)
            torch.matmul(g, w.t())

    return fn


def tree_rel_err(got: dict, want: dict) -> float:
    """max over leaves of max|got - want| / max|want| (leaves where want
    is zero everywhere are skipped)."""
    worst = 0.0
    for name, w in want.items():
        if w is not None and bool(w.abs().max() > 0):
            worst = max(worst, rel_err(got[name], w))
    return worst


def tree_mean_err(got: dict, want: dict) -> float:
    """max over leaves of mean|got - want| / mean|want|."""
    worst = 0.0
    for name, w in want.items():
        if w is not None and bool(w.abs().max() > 0):
            worst = max(worst, float((got[name] - w).abs().mean()
                                     / w.abs().mean()))
    return worst


def gate_text(gate: dict) -> str:
    return " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in gate.items() if k != "ok")


def phase_fused_tgt(model, cfg, device, gen, flush):
    """K1 and K2 against their plain versions under ``chain_gate`` (the
    kernels' products run on the tensor cores), with both negative
    controls failing it and a repeat launch bit-equal; K1 against the f32
    encoder and K2's gradients against its autograd; times at the train
    batches.  Returns both kernels' JSON fields (launches excluded)."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    d = cfg.embed_dim
    names = list(dict(model.named_parameters()))
    out = {}
    for kind in ("fwd", "bwd"):
        out[kind] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                         bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                         library_ms=0.0)
    dev_ms = {"fwd": 0.0, "bwd": 0.0}
    big = {"fwd": [], "bwd": []}
    for structure in STRUCTURE_NAMES:
        depth = mpqe_mod.num_steps(cfg, structure)
        blocks = ff.chain_blocks(cfg, structure)
        for B in (TRAIN_BATCH, RAGGED):
            args = shared_inputs(gen, cfg, structure, B)
            x0, ws, bs, n_a, dp = chain_operands(model, cfg, structure, args)
            g = torch.randn((B, d), generator=gen, device=device)
            with torch.no_grad():
                got = ff._chain_forward(x0, ws, bs, d, blocks)
                again = ff._chain_forward(x0, ws, bs, d, blocks)
                plain = ff._chain_forward_plain(x0, ws, bs, d)
                f32 = mpqe_mod.encode_dense(model, cfg, structure, *args)
                kb = ff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)
                kb2 = ff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)
                pb = ff._chain_backward_plain(x0, ws, bs, g, n_a, d, dp)
                controls = []
                for name, x, w in ff.chain_gate_controls(x0, ws, blocks,
                                                         n_a, d):
                    controls.append((
                        name, ff._chain_forward_plain(x, w, bs, d),
                        ff._chain_backward_plain(x, w, bs, g, n_a, d, dp)))
            dpar, den, _ = ff.fused_tgt_backward(model, cfg, structure, *args,
                                                 None, g)
            en = args[3].clone().requires_grad_()
            q = mpqe_mod.encode_dense(model, cfg, structure, *args[:3], en)
            ref = torch.autograd.grad(
                q, list(model.parameters()) + [en], g, allow_unused=True)
            torch.cuda.synchronize()
            kleaves = [kb[0], *kb[1], *kb[2]]
            for t in (got, *kleaves):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"{structure} B={B}: non-finite")
            repeat = bool(torch.equal(got, again)) and all(
                torch.equal(a, b) for a, b in zip(
                    kleaves, [kb2[0], *kb2[1], *kb2[2]]))
            L = len(ws)
            gf = ff.chain_gate(got, plain, L)
            gb = ff.chain_gate(kb, pb, L, blocks)
            fails = [not ff.chain_gate(got, cf, L)["ok"]
                     and not ff.chain_gate(kb, cb, L, blocks)["ok"]
                     for _, cf, cb in controls]
            e_f32 = rel_err(got, f32)
            got_g = {n: dpar[n] for n in names}
            want_g = dict(zip(names, ref[:-1]))
            e_grad = tree_mean_err(got_g, want_g)
            e_grad_max = tree_rel_err(got_g, want_g)
            # edge_norm's cotangent is a sum over the batch with heavy
            # cancellation, so its relative error is ill-conditioned:
            # printed, not gated (it is data, not a parameter)
            e_den = rel_err(den, ref[-1])
            masks = [blocks.mask(li).to(device) for li in range(L)]
            out["fwd"]["max_abs_err"] = max(out["fwd"]["max_abs_err"], float(
                (got - plain).abs().max()))
            out["bwd"]["max_abs_err"] = max(
                out["bwd"]["max_abs_err"], float((kb[0] - pb[0]).abs().max()),
                *(float((a - b)[m].abs().max())
                  for a, b, m in zip(kb[1], pb[1], masks)),
                *(float((a - b).abs().max()) for a, b in zip(kb[2], pb[2])))
            tol_grad = TOL_GRAD_BY_DEPTH[depth]
            line = (f"kernel.fused_tgt {structure:14s} B={B:5d} "
                    f"fwd_gate_ok={gf['ok']} ({gate_text(gf)}) "
                    f"bwd_gate_ok={gb['ok']} ({gate_text(gb)}) "
                    f"controls_fail={all(fails)} repeat_equal={repeat} "
                    f"fwd_err_vs_f32={e_f32:.3e} "
                    f"grad_mean_err_vs_f32_autograd={e_grad:.3e} "
                    f"(tol {tol_grad:g}, depth {depth}; max-element "
                    f"{e_grad_max:.3e}; edge_norm {e_den:.3e})")
            if (not gf["ok"] or not gb["ok"] or not all(fails) or not repeat
                    or e_f32 > TOL_F32 or e_grad > tol_grad):
                log(line + " FAIL")
                raise AssertionError(line)
            log(line)
            if B != TRAIN_BATCH:
                continue
            for kind, bwd in (("fwd", False), ("bwd", True)):
                if bwd:
                    def kfn():
                        ff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)

                    def pfn():
                        ff._chain_backward_plain(x0, ws, bs, g, n_a, d, dp)
                else:
                    def kfn():
                        ff._chain_forward(x0, ws, bs, d, blocks)

                    def pfn():
                        ff._chain_forward_plain(x0, ws, bs, d)
                with torch.no_grad():
                    ms = time_ms(kfn, ITERS, flush)
                    k_ms = device_ms(kfn, ITERS, flush)
                    plain_ms = time_ms(pfn, PLAIN_ITERS, flush)
                    lib_ms = time_ms(library_chain(x0, ws, bwd, gen), ITERS,
                                     flush)
                work = chain_work(cfg, structure, B, bwd)
                t_bytes, t_ops = bound_times(work)
                acc = out[kind]
                acc["ms"] += ms
                dev_ms[kind] += k_ms
                acc["plain_ms"] += plain_ms
                acc["library_ms"] += lib_ms
                acc["bound_ms"] += max(t_bytes, t_ops)
                acc["bytes_ms"] += t_bytes
                acc["ops_ms"] += t_ops
                log(f"kernel.fused_tgt{'_backward' if bwd else ''} "
                    f"{structure:14s} B={B} kernel_ms={ms:.4f} "
                    f"device_ms={k_ms:.4f} "
                    f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={max(t_bytes, t_ops):.6f} "
                    f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
                    f"{work[0]} B, {work[1]} bf16 FLOP, {work[2]} f32 FLOP)")
        # the flagship train batch: kernel, bound and yardstick only
        args = shared_inputs(gen, cfg, structure, TRAIN_BIG)
        x0, ws, bs, n_a, dp = chain_operands(model, cfg, structure, args)
        g = torch.randn((TRAIN_BIG, d), generator=gen, device=device)
        for kind, bwd in (("fwd", False), ("bwd", True)):
            kfn = ((lambda: ff._chain_backward(x0, ws, bs, g, n_a, d, dp,
                                               blocks))
                   if bwd else (lambda: ff._chain_forward(x0, ws, bs, d,
                                                          blocks)))
            with torch.no_grad():
                ms = time_ms(kfn, BIG_ITERS, flush)
                k_ms = device_ms(kfn, BIG_ITERS, flush)
                lib_ms = time_ms(library_chain(x0, ws, bwd, gen), BIG_ITERS,
                                 flush)
            work = chain_work(cfg, structure, TRAIN_BIG, bwd)
            t_bytes, t_ops = bound_times(work)
            big[kind].append((ms, k_ms, lib_ms, max(t_bytes, t_ops)))
            log(f"kernel.fused_tgt{'_backward' if bwd else ''} "
                f"{structure:14s} B={TRAIN_BIG} kernel_ms={ms:.4f} "
                f"device_ms={k_ms:.4f} "
                f"library_ms={lib_ms:.4f} "
                f"bound_ms={max(t_bytes, t_ops):.6f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
                f"{work[0]} B, {work[1]} bf16 FLOP, {work[2]} f32 FLOP)")
        del x0, ws, bs, g, args
    fields = {}
    for kind in ("fwd", "bwd"):
        acc = out[kind]
        by = "bytes" if acc.pop("bytes_ms") >= acc.pop("ops_ms") else \
            "operations"
        fields[kind] = {**acc, "bound_by": by}
        log(f"kernel.fused_tgt{'_backward' if kind == 'bwd' else ''} sum of "
            f"7 at B={TRAIN_BATCH}: kernel_ms={acc['ms']:.4f} "
            f"device_ms={dev_ms[kind]:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f} ({by}); at B={TRAIN_BIG}: "
            + " ".join(f"{name}={sum(r[i] for r in big[kind]):.4f}"
                       for i, name in enumerate(("kernel_ms", "device_ms",
                                                 "library_ms")))
            + f" bound_ms={sum(r[3] for r in big[kind]):.6f}")
    return fields


def profile_device(label: str, fn, top: int = 8, also=()) -> None:
    """Device time by kernel over ``fn()`` (torch.profiler) and the
    device's busy share of its wall time: the ``top`` kernels, then any
    other whose name contains one of ``also``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device work only: a user annotation's range (``Optimizer.step``)
    # spans kernels that are counted on their own
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%)")
    shown = rows[:top] + [r for r in rows[top:]
                          if any(a in r[2] for a in also)]
    for us, count, key in shown:
        log(f"{label}:   {us / 1e3:9.3f} ms {count:5d}x "
            f"{100 * us / wall_us:5.1f}% of wall {100 * us / busy:5.1f}% "
            f"of busy {key[:90]}")


class PlainChain(torch.autograd.Function):
    """``FusedChain`` of ``mpqe_tpu_torch/ops/fused_fwd.py`` with the plain
    versions of K1 and K2 in place of the kernels: same operands, same
    rounding, gradients routed the same way (the train-step recheck)."""

    @staticmethod
    def forward(ctx, node_mode, layout, *tensors):
        from mpqe_tpu_torch.ops import fused_fwd as ff

        cfg, v_slots, d_pad, n_a, _ = layout
        L = (len(tensors) - n_a) // 2
        cols, Ws, bs = tensors[:n_a], tensors[n_a:n_a + L], tensors[n_a + L:]
        x0 = ff._layer0_operand(cols, node_mode, v_slots, cfg, d_pad)
        ws = [W.to(torch.bfloat16) for W in Ws]
        ctx.save_for_backward(x0, *ws, *bs)
        ctx.meta = (n_a, L, cfg.embed_dim, d_pad)
        return ff._chain_forward_plain(x0, ws, bs, cfg.embed_dim)

    @staticmethod
    def backward(ctx, g):
        from mpqe_tpu_torch.ops import fused_fwd as ff

        n_a, L, d, d_pad = ctx.meta
        x0, *rest = ctx.saved_tensors
        da, dws, dbs = ff._chain_backward_plain(
            x0, rest[:L], rest[L:], g.to(torch.float32), n_a, d, d_pad)
        return (None, None, *(da[:, k] for k in range(n_a)), *dws, *dbs)


def recheck_train_step(state, cfg, stores, device) -> None:
    """One step per structure from the trained state, through the kernels
    and through their plain versions (:class:`PlainChain`) on the card:
    the same loss (<= TOL_PLAIN relative) and gradients, per leaf
    mean|diff| / mean|ref| <= TOL_PLAIN (the kernels' products take the
    tensor cores' sum order, so a bf16 flip may move single elements; the
    max-element figure is printed beside the gate, as for
    ``recheck_sparse_step``)."""
    from mpqe_tpu_torch.data.store import pack_dense_batch_np
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.train import loop as loop_mod

    model = state.model
    params = dict(model.named_parameters())
    for structure, f_stores in stores.items():
        fstore = max(f_stores, key=lambda f: f.n_queries)
        batch = pack_dense_batch_np(
            fstore, np.arange(fstore.n_queries), TRAIN_BATCH, 4, 11)
        t = loop_mod.batch_tensors(batch, device)
        loss_k = mpqe_mod.dense_batch_loss_kernel_fused_fwd(
            model, cfg, structure, *t, backward="pallas")
        g_k = torch.autograd.grad(loss_k, list(params.values()),
                                  allow_unused=True)
        v_slots, d_pad, cols, Ws, bs = ff._assemble(model, cfg, structure,
                                                    *t[:4], None)
        q = PlainChain.apply(t[1], (cfg, tuple(v_slots), d_pad, len(cols),
                                    None), *cols, *Ws, *bs)
        loss_p = mpqe_mod.margin_loss_from_queries(model, cfg, q, *t[4:])
        g_p = torch.autograd.grad(loss_p, list(params.values()),
                                  allow_unused=True)
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        e_loss = abs(lk - lp) / max(abs(lp), 1e-12)
        gk, gp = dict(zip(params, g_k)), dict(zip(params, g_p))
        e_grad = tree_mean_err(gk, gp)
        e_grad_max = tree_rel_err(gk, gp)
        line = (f"train.recheck {structure:14s} loss={lk:.6f} "
                f"loss_err={e_loss:.3e} grad_mean_err={e_grad:.3e} "
                f"grad_max_err={e_grad_max:.3e}")
        log(line)
        if e_loss > TOL_PLAIN or e_grad > TOL_PLAIN or not np.isfinite(lk):
            raise AssertionError(line)


def sample_train_queries(kg):
    """(train, val) queries of every structure, grouped by formula."""
    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, group_queries_by_formula

    t0 = time.perf_counter()
    sampler = QuerySampler(kg, seed=7)
    train_q, val_q = [], []
    for s in STRUCTURE_NAMES:
        train_q += sampler.sample_queries(s, 256, n_neg=32)
        val_q += sampler.sample_queries(s, 64, n_neg=64)
    log(f"setup: sampled train/val queries {time.perf_counter() - t0:.2f} s")
    return group_queries_by_formula(train_q), group_queries_by_formula(val_q)


def phase_train(kg, train_q, val_q, device):
    """``run_train`` on the card through K1/K2 with one validation round
    (K3).  Returns (K1 launches, K2 launches)."""
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    # burn-in off: no structure is named "none", so every structure
    # trains from the first step
    tc = loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                              max_steps=TRAIN_STEPS, val_every=TRAIN_STEPS,
                              burn_in_structure="none", seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    state = loop_mod.init_train_state(gen, cfg, tc, device=device)

    real = []  # per step, the batch's real rows (the sum of query_mask)

    def loss_fn(*a):
        real.append(a[-1].sum())
        return mpqe_mod.dense_batch_loss_kernel_fused_fwd(*a,
                                                          backward="pallas")

    t0 = time.perf_counter()
    loop_mod.warmup_train_step(
        lambda opt: loop_mod.make_train_step(cfg, opt, loss_fn), cfg, tc,
        STRUCTURE_NAMES, device)
    torch.cuda.synchronize()
    log(f"setup: warmup (one throwaway step per structure) "
        f"{time.perf_counter() - t0:.2f} s")

    records = []

    ff.fused_tgt_forward.launches = 0
    ff.fused_tgt_backward.launches = 0
    ff.fused_tgt_forward_multi.launches = 0
    real.clear()
    t0 = time.perf_counter()
    loop_mod.run_train(state, cfg, tc, train_q, val_queries=val_q,
                       log_fn=records.append, batch_loss_fn=loss_fn, kg=kg)
    wall = time.perf_counter() - t0
    k1 = ff.fused_tgt_forward.launches
    k2 = ff.fused_tgt_backward.launches
    k3 = ff.fused_tgt_forward_multi.launches
    losses = [r["loss"] for r in records if "loss" in r]
    vals = [r["val"] for r in records if "val" in r]
    log(f"train: {state.step} steps in {wall:.2f} s; launches K1={k1} "
        f"K2={k2} K3={k3}; loss first={losses[0]:.6f} "
        f"last={losses[-1]:.6f}; val macro_auc="
        f"{vals[-1]['auc_macro'] if vals else float('nan'):.4f}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {len(losses)} steps, finite: "
                             f"{all(np.isfinite(losses))}")
    if not (k1 == k2 == TRAIN_STEPS) or k3 == 0 or not vals:
        raise AssertionError(f"launches K1={k1} K2={k2} K3={k3}, "
                             f"{len(vals)} validation rounds")
    # each step's seconds end with the host reading its loss
    ms = np.asarray([r["seconds"] * 1e3 for r in records if "loss" in r])
    n_real = int(torch.stack(real).sum())
    stores = build_stores(train_q, kg=kg)
    per_formula = [f.n_queries for fs in stores.values() for f in fs]
    name = torch.cuda.get_device_name(device)
    # a batch holds the queries of one formula; on this KG nearly every
    # sampled formula is unique, so the batches are mostly padding
    log(f"train: {len(ms)} steps of batch {TRAIN_BATCH} on {name}: "
        f"step_ms_p50={np.percentile(ms, 50):.3f} "
        f"step_ms_p95={np.percentile(ms, 95):.3f} "
        f"train_queries_per_s={n_real / ms.sum() * 1e3:.1f} "
        f"({n_real} real rows of {len(ms) * TRAIN_BATCH}; "
        f"{np.mean(per_formula):.2f} queries per formula over "
        f"{len(per_formula)} formulas) "
        f"padded_rows_per_s={len(ms) * TRAIN_BATCH / ms.sum() * 1e3:.1f}")

    recheck_train_step(state, cfg, stores, device)
    ptc = dataclasses.replace(tc, max_steps=PROFILE_STEPS, val_every=1 << 30)
    profile_device(f"train.profile ({PROFILE_STEPS} steps)",
                   lambda: loop_mod.run_train(state, cfg, ptc, train_q,
                                              batch_loss_fn=loss_fn, kg=kg),
                   also=TGT_KERNELS)
    return k1, k2


def phase_train_cli(kernel_args, then=None) -> None:
    """``python -m mpqe_tpu_torch.train`` with ``kernel_args`` on the card
    as a subprocess: its final line and its run dir, handed to ``then``
    before it is deleted."""
    import os
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "mpqe_tpu_torch.train",
               "--data", "synthetic", *kernel_args, "--steps", "20",
               "--val_every", "10", "--num_bases", "16", "--n_neg", "4",
               "--syn_entities", "20000", "--syn_modes", "4",
               "--syn_rels", "20", "--syn_triples", "60000",
               "--syn_train_queries", "700", "--syn_val_queries", "140",
               "--run_dir", run_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        log(f"train.cli {' '.join(kernel_args)}: rc={proc.returncode} "
            f"{time.perf_counter() - t0:.2f} s: {last}")
        if proc.returncode != 0:
            raise AssertionError(f"train CLI failed:\n{proc.stderr[-4000:]}")
        if not re.fullmatch(r"final step=20 macro_auc=\S+ macro_apr=\S+",
                            last):
            raise AssertionError(f"unexpected final line {last!r}")
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
        for f in ("config.json", "model_config.json", "metrics.jsonl"):
            if not os.path.isfile(os.path.join(run_dir, f)):
                raise AssertionError(f"run dir lacks {f}")
        if "step_20" not in ckpts:
            raise AssertionError(f"run dir checkpoints: {ckpts}")
        log(f"train.cli: run dir holds config.json, model_config.json, "
            f"metrics.jsonl, ckpt/{','.join(ckpts)}")
        if then is not None:
            then(run_dir)


# ----------------------------------------------------------------------
# The sparse path: K5a / K5b (relation chunks) and K6a / K6b (blocked)
# ----------------------------------------------------------------------
K5_KERNELS = ("k5_msg_kernel", "k5_combine_kernel")
K6A_KERNELS = ("k6a_messages_kernel",)
K6B_KERNELS = ("k6b_grad_kernel", "k6b_dcoeff_kernel",
               "reduce_partials_kernel", "k6b_s_")
# widths beyond what K5 and K6 stage whole in shared memory: K5 at K = 768
# (N = K, and N != K), K6 at d = 256 and 512, all with 16 bases, on the
# 3-chain_inter template batch at the train batch
WIDE_K5 = ((768, 768), (768, 256))
WIDE_K6 = (256, 512)
WIDE_BASES = 16
WIDE_STRUCTURE = "3-chain_inter"


def general_store(cfg):
    """The reference's own kernel-bench graph
    (mpqe_tpu/ops/pallas_rgcn_blocked.py:57-58): GENERAL_NODES nodes and
    GENERAL_EDGES random typed edges, relation-sorted."""
    from mpqe_tpu_torch.ops.edge_store import build_edge_store

    rng = np.random.default_rng(5)
    n, e = GENERAL_NODES, GENERAL_EDGES
    return build_edge_store(rng.integers(0, n, e), rng.integers(0, n, e),
                            rng.integers(0, cfg.n_rels, e), n, cfg.n_rels)


def template_rel_norm(gen, cfg, structure):
    from mpqe_tpu_torch.queries import STRUCTURES

    ne = STRUCTURES[structure].n_edges
    er = torch.randint(0, cfg.n_rels, (ne,), generator=gen,
                       device=gen.device, dtype=torch.int32)
    return er, 0.5 + torch.rand((ne,), generator=gen, device=gen.device)


def k5_work(n_edges_pad: int, n_real: int, n_src_rows: int, K: int, N: int,
            weight_bytes: int, coeff_bytes: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP, TF32 FLOP) of one K5 launch: the
    ``n_src_rows`` distinct rows of x that real edges gather, the src ids
    and norms, the coefficients and relation ids, the weights (the basis
    once, or each distinct relation's W once) and the f32 output, each
    once; 2 K N f32 FLOP per real edge (padding edges need none), or 3 x
    that in TF32 on the tensor cores (split TF32: f32-grade products), the
    route ``bound_times`` takes when it is faster."""
    nbytes = (n_src_rows * K * 4 + n_edges_pad * (4 + 4 + N * 4)
              + coeff_bytes + weight_bytes)
    f32 = 2 * n_real * K * N
    return nbytes, 0, f32, 3 * f32


def k6_work(n_edges_pad: int, n_chunks: int, n_real: int, n_rows: int,
            K: int, N: int, bb: int, n_rels: int, grad: bool) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one K6a (or K6b) launch: bf16 x
    (and g), bf16 basis, f32 coeff, the per-edge src/dst/rel/norm and the
    per-chunk block ids, the f32 output (or dbasis and dcoeff), each once;
    2 E Bb K N bf16 FLOP over the real edges for K6a (the products
    ``xs @ V_b``), twice that for K6b (those and ``xs^T rhs``), plus the
    f32 work outside those products: for K6a the coefficient scaling and
    sum over bases, the norm and the destination sum; for K6b ``gn``, the
    ``s_eb`` dot products and the ``rhs`` scaling."""
    edges = n_edges_pad * 16 + n_chunks * 8
    params = bb * K * N * 2 + n_rels * bb * 4
    if not grad:
        return (n_rows * K * 2 + params + edges + n_rows * N * 4,
                2 * n_real * bb * K * N, n_real * (2 * bb * N + 2 * N))
    return (n_rows * (K + N) * 2 + params + edges + bb * K * N * 4
            + n_rels * bb * 4, 4 * n_real * bb * K * N,
            n_real * (bb * 3 * N + N))


def add_case(acc: dict, ms, plain_ms, lib_ms, work, dev_ms=0.0):
    t_bytes, t_ops = bound_times(work)
    acc["ms"] += ms
    acc["plain_ms"] += plain_ms
    acc["library_ms"] += lib_ms
    acc["device_ms"] += dev_ms
    acc["bound_ms"] += max(t_bytes, t_ops)
    acc["bytes_ms"] += t_bytes
    acc["ops_ms"] += t_ops
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def new_acc() -> dict:
    return dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                bytes_ms=0.0, ops_ms=0.0, library_ms=0.0, device_ms=0.0)


def finish_acc(acc: dict) -> dict:
    """The JSON fields of an accumulator (sums over the 7 structures at
    the train batch)."""
    acc = dict(acc)
    by = "bytes" if acc.pop("bytes_ms") >= acc.pop("ops_ms") else \
        "operations"
    acc.pop("device_ms")
    return {**acc, "bound_by": by}


def work_line(ms, dev_ms, plain_ms, lib_ms, bound, by, work) -> str:
    return (f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} "
            + (f"plain_ms={plain_ms:.4f} " if plain_ms is not None else "")
            + f"library_ms={lib_ms:.4f} bound_ms={bound:.6f} ({by}: "
            f"{work[0]} B, {work[1]} bf16 FLOP, {work[2]} f32 FLOP"
            + (f" or {work[3]} TF32 FLOP" if len(work) > 3 else "") + ")")


def k5_cases(cfg, gen, device):
    """(label, B, chunked dict on the card, n_nodes) for the 7 structures
    at the train batch and the flagship train batch, then the general
    graph (chunk_by_relation, padded chunks)."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    for B in (TRAIN_BATCH, TRAIN_BIG):
        for s in STRUCTURE_NAMES:
            er, en = template_rel_norm(gen, cfg, s)
            yield s, B, tl.template_chunked(s, er, en, B), \
                B * STRUCTURES[s].n_nodes
    ch = rf.chunk_by_relation(general_store(cfg))
    yield "general", 0, {k: (torch.from_numpy(v).to(device)
                             if isinstance(v, np.ndarray) else v)
                         for k, v in ch.items()}, GENERAL_NODES


def k5_control(coeff, crel, norm, chunk: int, basis_kind: bool, R: int):
    """The negative control's chunk coefficients (K5a) or relations (K5b):
    those of the first chunk with a real edge changed (its coefficient
    row negated and shifted, or the next relation)."""
    real = (norm.view(-1, chunk) != 0).any(1)
    c = int(torch.nonzero(real)[0, 0])
    bad = coeff.clone()
    if basis_kind:
        bad[c] = 1.0 - 2.0 * bad[c]
    else:
        bad[c] = (bad[c] + 1) % R
    return bad


def phase_rgcn_fused(layer_b, layer_f, cfg, device, gen, flush):
    """K5a (basis layer) and K5b (full-weight layer) against their plain
    versions (<= TOL_PLAIN) and the f32 batched oracle (<= TOL_ORACLE), a
    repeat launch bit-equal, the negative control (the plain version with
    one chunk's coefficients or relation changed) failing the plain gate,
    the transposed-weight read (the backward's) against the plain version
    on a transposed copy (<= TOL_PLAIN); times beside the bound, the plain
    version and the torch.bmm yardstick.  Returns both kernels' JSON fields
    (launches excluded)."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    d, R = cfg.embed_dim, cfg.n_rels
    basis = layer_b.basis.detach()
    coeff = layer_b.coeff.detach()
    w_rel = layer_f.w_rel.detach()
    eye = torch.eye(R, device=device)
    accs = {"K5a": new_acc(), "K5b": new_acc()}
    big = {"K5a": [], "K5b": []}
    f32_bound = {"K5a": 0.0, "K5b": 0.0}
    for label, B, ch, n in k5_cases(cfg, gen, device):
        src = ch["src"].to(torch.int32).contiguous()
        norm = ch["norm"].float().contiguous()
        crel = ch["chunk_rel"].to(torch.int32).contiguous()
        chunk = ch["chunk"]
        n_chunks = crel.shape[0]
        x = torch.randn((n, d), generator=gen, device=device)
        rows = torch.randn((src.shape[0], d), generator=gen, device=device)
        valid = crel < R
        real = norm != 0
        n_real = int(real.sum())
        n_src_rows = int(torch.unique(src[real].clamp(0, n - 1)).numel())
        n_used = int(torch.unique(crel[valid]).numel())  # relations met
        for kid in ("K5a", "K5b"):
            # the kernel's arguments between the weights and norm (kargs)
            # and the plain version's (c: per-chunk coefficients or ids)
            if kid == "K5a":
                c = rf._masked_chunk_coeff(coeff, crel, R).contiguous()
                w, fn, ref = basis, rf.messages_basis, \
                    rf.messages_basis_reference
                kargs = (coeff, crel, R)
                oracle_w, oracle_c = basis, coeff
                weight_bytes = basis.numel() * 4
                coeff_bytes = n_used * basis.shape[0] * 4 + n_chunks * 4
                w_c = rf.combine_basis(basis, c)
            else:
                c = crel.clamp(0, R - 1)
                w, fn, ref = w_rel, rf.messages_wrel, \
                    rf.messages_wrel_reference
                kargs = (crel,)
                oracle_w, oracle_c = w_rel, eye
                weight_bytes = n_used * d * d * 4
                coeff_bytes = n_chunks * 4
                w_c = w_rel[c.long()]
            with torch.no_grad():
                got = fn(x, src, w, *kargs, norm, chunk)
                again = fn(x, src, w, *kargs, norm, chunk)
                plain = ref(x, src, w, c, norm, chunk)
                oracle = rf._edge_messages_xla(x, oracle_w, oracle_c, src,
                                               norm, crel, R, chunk)
                cut = ref(x, src, w, k5_control(c, crel, norm, chunk,
                                                kid == "K5a", R),
                          norm, chunk)
                got_t = fn(rows, None, w, *kargs, norm, chunk,
                           w_transposed=True)
                plain_t = ref(rows, None, w.transpose(1, 2), c, norm, chunk)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kid} {label} B={B}: non-finite")
            e_plain, e_orc = rel_err(got, plain), rel_err(got, oracle)
            e_cut, e_t = rel_err(got, cut), rel_err(got_t, plain_t)
            repeat = torch.equal(got, again)
            accs[kid]["max_abs_err"] = max(accs[kid]["max_abs_err"], float(
                (got - plain).abs().max()))
            line = (f"kernel.rgcn_fused {kid} {label:14s} B={B:6d} "
                    f"E={src.shape[0]} err_vs_plain={e_plain:.3e} "
                    f"err_vs_f32_oracle={e_orc:.3e} repeat_equal={repeat} "
                    f"control_err={e_cut:.3e} transposed_err={e_t:.3e}")
            if (e_plain > TOL_PLAIN or e_orc > TOL_ORACLE or not repeat
                    or e_cut <= TOL_PLAIN or e_t > TOL_PLAIN):
                log(line + " FAIL")
                raise AssertionError(line)
            del again, cut, got_t, plain_t
            iters = ITERS if B == TRAIN_BATCH else BIG_ITERS
            xs_c = x[src.long().clamp(0, n - 1)].view(-1, chunk, d)
            with torch.no_grad():
                ms = time_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                             iters, flush)
                k_ms = device_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                                 iters, flush, K5_KERNELS,
                                 2 if kid == "K5a" else 1)
                plain_ms = time_ms(lambda: ref(x, src, w, c, norm, chunk),
                                   PLAIN_ITERS if B == TRAIN_BATCH else 1,
                                   flush)
                lib_ms = time_ms(lambda: torch.bmm(xs_c, w_c), iters, flush)
            work = k5_work(src.shape[0], n_real, n_src_rows, d, d,
                           weight_bytes, coeff_bytes)
            f32_ms = max(bound_times(work[:3]))  # the f32-pipe route
            if B == TRAIN_BATCH:
                bound, by = add_case(accs[kid], ms, plain_ms, lib_ms, work,
                                     k_ms)
                f32_bound[kid] += f32_ms
            else:
                t_b, t_o = bound_times(work)
                bound, by = max(t_b, t_o), ("bytes" if t_b >= t_o
                                            else "operations")
                big[kid].append((label, ms, k_ms, lib_ms, bound, f32_ms))
            log(line + " " + work_line(ms, k_ms, plain_ms, lib_ms, bound, by,
                                       work)
                + f" f32_route_bound_ms={f32_ms:.6f}")
            del got, plain, oracle, xs_c, w_c
        del x, rows
    fields = {}
    for kid, acc in accs.items():
        t7 = [v for v in big[kid] if v[0] != "general"]
        log(f"kernel.rgcn_fused {kid} sum of 7 at B={TRAIN_BATCH}: "
            f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f} "
            f"f32_route_bound_ms={f32_bound[kid]:.6f}; at B={TRAIN_BIG}: "
            + " ".join(f"{k}={sum(v[i] for v in t7):.4f}" for i, k in (
                (1, "kernel_ms"), (2, "device_ms"), (3, "library_ms"),
                (4, "bound_ms"), (5, "f32_route_bound_ms"))))
        fields[kid] = finish_acc(acc)
    wide_rgcn_fused(cfg, device, gen, flush)
    return fields


def wide_rgcn_fused(cfg, device, gen, flush):
    """K5a and K5b at the widths of WIDE_K5 (k in stages on the card), on
    the WIDE_STRUCTURE template at the train batch, random weights: the
    gates, repeat and negative control of :func:`phase_rgcn_fused`, and
    times beside the bound."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURES

    R, s, B = cfg.n_rels, WIDE_STRUCTURE, TRAIN_BATCH
    er, en = template_rel_norm(gen, cfg, s)
    ch = tl.template_chunked(s, er, en, B)
    n = B * STRUCTURES[s].n_nodes
    src = ch["src"].to(torch.int32).contiguous()
    norm = ch["norm"].float().contiguous()
    crel = ch["chunk_rel"].to(torch.int32).contiguous()
    chunk = ch["chunk"]
    real = norm != 0
    n_real = int(real.sum())
    n_src_rows = int(torch.unique(src[real].clamp(0, n - 1)).numel())
    n_used = int(torch.unique(crel[crel < R]).numel())
    for K, N in WIDE_K5:
        x = torch.randn((n, K), generator=gen, device=device)
        basis = torch.randn((WIDE_BASES, K, N), generator=gen,
                            device=device) / K ** 0.5
        coeff = torch.randn((R, WIDE_BASES), generator=gen, device=device)
        for kid in ("K5a", "K5b"):
            if kid == "K5a":
                c = rf._masked_chunk_coeff(coeff, crel, R).contiguous()
                w, fn, ref = basis, rf.messages_basis, \
                    rf.messages_basis_reference
                kargs, oracle_w, oracle_c = (coeff, crel, R), basis, coeff
                weight_bytes = basis.numel() * 4
                coeff_bytes = n_used * WIDE_BASES * 4 + crel.numel() * 4
            else:
                c = crel.clamp(0, R - 1)
                w = torch.einsum("rb,bio->rio", coeff, basis).contiguous()
                fn, ref = rf.messages_wrel, rf.messages_wrel_reference
                kargs = (crel,)
                oracle_w, oracle_c = w, torch.eye(R, device=device)
                weight_bytes = n_used * K * N * 4
                coeff_bytes = crel.numel() * 4
            with torch.no_grad():
                got = fn(x, src, w, *kargs, norm, chunk)
                again = fn(x, src, w, *kargs, norm, chunk)
                plain = ref(x, src, w, c, norm, chunk)
                oracle = rf._edge_messages_xla(x, oracle_w, oracle_c, src,
                                               norm, crel, R, chunk)
                cut = ref(x, src, w, k5_control(c, crel, norm, chunk,
                                                kid == "K5a", R),
                          norm, chunk)
            torch.cuda.synchronize()
            e_plain, e_orc = rel_err(got, plain), rel_err(got, oracle)
            e_cut, repeat = rel_err(got, cut), torch.equal(got, again)
            line = (f"kernel.rgcn_fused.wide {kid} {s} B={B} K={K} N={N} "
                    f"E={src.shape[0]} err_vs_plain={e_plain:.3e} "
                    f"err_vs_f32_oracle={e_orc:.3e} repeat_equal={repeat} "
                    f"control_err={e_cut:.3e}")
            if (e_plain > TOL_PLAIN or e_orc > TOL_ORACLE or not repeat
                    or e_cut <= TOL_PLAIN
                    or not bool(torch.isfinite(got).all())):
                log(line + " FAIL")
                raise AssertionError(line)
            del again, plain, oracle, cut
            with torch.no_grad():
                ms = time_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                             ITERS, flush)
                k_ms = device_ms(lambda: fn(x, src, w, *kargs, norm, chunk),
                                 ITERS, flush, K5_KERNELS,
                                 2 if kid == "K5a" else 1)
            work = k5_work(src.shape[0], n_real, n_src_rows, K, N,
                           weight_bytes, coeff_bytes)
            t_b, t_o = bound_times(work)
            log(line + f" kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
                f"bound_ms={max(t_b, t_o):.6f} ("
                f"{'bytes' if t_b >= t_o else 'operations'})")
            del got, w
        del x, basis, coeff


def k6_cases(cfg, gen, device):
    """(label, B, bucketed dict, n_nodes): template_blocked for the 7
    structures at both batches, then bucket_edges_blocked of the general
    graph at the defaults (off-diagonal buckets, padding chunks)."""
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    for B in (TRAIN_BATCH, TRAIN_BIG):
        for s in STRUCTURE_NAMES:
            er, en = template_rel_norm(gen, cfg, s)
            yield s, B, tl.template_blocked(s, er, en, B), \
                B * STRUCTURES[s].n_nodes
    yield "general", 0, rb.bucket_edges_blocked(general_store(cfg)), \
        GENERAL_NODES


def k6a_check(rb, got, again, x, w, coeff, lay, R, n):
    """K6a on one layout held to its plain version under
    ``blocked_error_bound``, its repeat launch to the same bits, and the
    negative control (the plain result with one real edge's message
    removed) to a failing gate.  Returns (gate, control failed, max|diff|)."""
    msg = rb._edge_messages(x, w, coeff, lay, R)
    plain = rb._dst_sum(msg, lay, n)
    bound = rb.blocked_error_bound(x, w, coeff, lay, R, n, msg)
    gate = rb.k6a_gate(got, plain, bound)
    gate["repeat_equal"] = torch.equal(got, again)
    real = torch.nonzero(rb._real_edges(lay, n)[2]).squeeze(1)
    e = real[real.numel() // 2:][:1]
    cut = rb._dst_sum(msg.index_fill(0, e, 0.0), lay, n)
    gate["control_fails"] = not rb.k6a_gate(got, cut, bound)["ok"]
    return gate, float((got - plain).abs().max())


def phase_rgcn_blocked(layer_b, cfg, device, gen, flush):
    """K6a (forward and transpose layout) within its stated bound of its
    plain version and K6b under its gate (``ops/rgcn_blocked.py``
    ``k6a_gate``, ``k6b_gate``), each negative control failing, repeat
    launches bit-equal, K6a against the f32 twin (<= TOL_F32, small cases
    only: the twin materializes [E, Bb, d]); the edge lists' build time
    apart, times beside the bound, the plain version and a cuBLAS
    yardstick.  Returns both kernels' JSON fields (launches excluded)."""
    from mpqe_tpu_torch.ops import rgcn_blocked as rb

    d, R = cfg.embed_dim, cfg.n_rels
    basis = layer_b.basis.detach()
    coeff = layer_b.coeff.detach()
    bb = basis.shape[0]
    v_cat = basis.permute(1, 0, 2).reshape(d, bb * d).to(torch.bfloat16)
    accs = {"K6a": new_acc(), "K6b": new_acc()}
    big = {"K6a": [], "K6b": []}
    for label, B, bk, n in k6_cases(cfg, gen, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay, t_lay = rb.layouts_on(bk, device)
        torch.cuda.synchronize()
        lists_ms = (time.perf_counter() - t0) * 1e3
        x = torch.randn((n, d), generator=gen, device=device)
        g = torch.randn((n, d), generator=gen, device=device)
        E = lay["src_local"].shape[0]
        n_chunks = lay["chunk_dst_blk"].shape[0]
        n_real = int(lay["part_ptr"][-1])
        basis_t = basis.transpose(1, 2)
        with torch.no_grad():
            got = rb.messages_blocked(x, basis, coeff, lay, R)
            got2 = rb.messages_blocked(x, basis, coeff, lay, R)
            got_t = rb.messages_blocked(g, basis_t, coeff, t_lay, R)
            got_t2 = rb.messages_blocked(g, basis_t, coeff, t_lay, R)
            got_g = rb.grad_blocked_parts(x, g, basis, coeff, lay, R)
            got_g2 = rb.grad_blocked_parts(x, g, basis, coeff, lay, R)
            torch.cuda.synchronize()
            for t in (got, got_t, *got_g):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"K6 {label} B={B}: non-finite")
            ga, err_a = k6a_check(rb, got, got2, x, basis, coeff, lay, R, n)
            gt, err_t = k6a_check(rb, got_t, got_t2, g, basis_t, coeff,
                                  t_lay, R, n)
            plain_g = rb.grad_blocked_reference_parts(x, g, basis, coeff,
                                                      lay, R)
            s_bound = rb.grad_s_bound(x, g, basis, lay)
            gb = rb.k6b_gate(got_g, plain_g, s_bound, lay["rel"], R)
            gb["repeat_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(got_g, got_g2))
            r = int(lay["edges"][0, 2])
            cut_lay = dict(lay, norm=torch.where(lay["rel"] == r, 0.0,
                                                 lay["norm"]))
            bad = rb.k6b_gate(got_g, rb.grad_blocked_reference_parts(
                x, g, basis, coeff, cut_lay, R), s_bound, lay["rel"], R)
            gb["control_fails"] = not bad["dbasis_ok"] and \
                not bad["dcoeff_ok"]
        accs["K6a"]["max_abs_err"] = max(accs["K6a"]["max_abs_err"], err_a,
                                         err_t)
        accs["K6b"]["max_abs_err"] = max(accs["K6b"]["max_abs_err"], *(
            float((a - b).abs().max()) for a, b in zip(got_g[:2],
                                                       plain_g[:2])))
        line = (f"kernel.rgcn_blocked {label:14s} B={B:6d} E={E} "
                f"real={n_real} lists_ms={lists_ms:.3f} ")
        for tag, gate in (("K6a", ga), ("K6a_t", gt)):
            line += (f"{tag}: flip_share={gate['flip_share']:.3e} "
                     f"rel_err={gate['rel_err']:.3e} "
                     f"diff_over_bound={gate['bound_ratio']:.3e} "
                     f"control_fails={gate['control_fails']} "
                     f"repeat_equal={gate['repeat_equal']} ")
        line += (f"K6b: dbasis_err={gb['dbasis_err']:.3e} "
                 f"s_flip_share={gb['s_flip_share']:.3e} "
                 f"s_beyond_neighbour={gb['s_beyond_neighbour']} "
                 f"dcoeff_err={gb['dcoeff_err']:.3e} "
                 f"control_fails={gb['control_fails']} "
                 f"repeat_equal={gb['repeat_equal']}")
        ok = all(gate["ok"] and gate["control_fails"]
                 and gate["repeat_equal"] for gate in (ga, gt, gb))
        if B == TRAIN_BATCH:
            with torch.no_grad():
                twin = rb._messages_xla_twin(
                    x, basis, coeff, *(lay[k] for k in (
                        "src_local", "dst_local", "rel", "norm",
                        "chunk_src_blk", "chunk_dst_blk")), R,
                    lay["node_block"], lay["chunk"])
            e_twin = rel_err(got, twin)
            line += f" K6a_err_vs_f32_twin={e_twin:.3e}"
            ok = ok and e_twin <= TOL_F32
            del twin
        if not ok:
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        del plain_g, got2, got_t2, got_g2, s_bound
        iters = ITERS if B == TRAIN_BATCH else BIG_ITERS
        p_iters = PLAIN_ITERS_K6 if B == TRAIN_BATCH else 1
        row, okr = rb._global_rows(lay, lay["src_local"], "chunk_src_blk", n)
        xs16 = torch.where(okr[:, None], x[row], 0.0).to(torch.bfloat16)
        rhs16 = torch.randn((E, bb * d), generator=gen, device=device).to(
            torch.bfloat16)
        cases = (
            ("K6a", False, lambda: rb.messages_blocked(x, basis, coeff, lay,
                                                       R),
             lambda: rb.messages_blocked_reference(x, basis, coeff, lay, R,
                                                   n),
             lambda: torch.matmul(xs16, v_cat), K6A_KERNELS),
            ("K6b", True, lambda: rb.grad_blocked(x, g, basis, coeff, lay, R),
             lambda: rb.grad_blocked_reference(x, g, basis, coeff, lay, R),
             lambda: (torch.matmul(xs16, v_cat),
                      torch.matmul(xs16.t(), rhs16)), K6B_KERNELS))
        for kid, grad, kfn, pfn, lfn, names in cases:
            with torch.no_grad():
                ms = time_ms(kfn, iters, flush)
                k_ms = device_ms(kfn, iters, flush, names)
                plain_ms = time_ms(pfn, p_iters, flush)
                lib_ms = time_ms(lfn, iters, flush)
            work = k6_work(E, n_chunks, n_real, n, d, d, bb, R, grad)
            if B == TRAIN_BATCH:
                bound, by = add_case(accs[kid], ms, plain_ms, lib_ms, work,
                                     k_ms)
            else:
                t_b, t_o = bound_times(work)
                bound, by = max(t_b, t_o), ("bytes" if t_b >= t_o
                                            else "operations")
                big[kid].append((label, ms, k_ms))
            log(f"kernel.rgcn_blocked {kid} {label:14s} B={B:6d} "
                + work_line(ms, k_ms, plain_ms, lib_ms, bound, by, work))
        del x, g, got, got_t, got_g, xs16, rhs16, lay, t_lay
    fields = {}
    for kid, acc in accs.items():
        tpl = [(m, k) for lb, m, k in big[kid] if lb != "general"]
        log(f"kernel.rgcn_blocked {kid} sum of 7 at B={TRAIN_BATCH}: "
            f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f}; at B={TRAIN_BIG}: kernel_ms="
            f"{sum(m for m, _ in tpl):.4f} device_ms="
            f"{sum(k for _, k in tpl):.4f}")
        fields[kid] = finish_acc(acc)
    wide_rgcn_blocked(cfg, device, gen, flush)
    return fields


def wide_rgcn_blocked(cfg, device, gen, flush):
    """K6a (both layouts) and K6b at the widths of WIDE_K6 with
    WIDE_BASES bases (the basis streamed, dbasis in tiles, s_eb in column
    tiles on the card), on the WIDE_STRUCTURE template at the train batch,
    random weights: the gates, controls and repeats of
    :func:`phase_rgcn_blocked`, and times beside the bound."""
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import template_layout as tl
    from mpqe_tpu_torch.queries import STRUCTURES

    R, s, B, bb = cfg.n_rels, WIDE_STRUCTURE, TRAIN_BATCH, WIDE_BASES
    er, en = template_rel_norm(gen, cfg, s)
    lay, t_lay = rb.layouts_on(tl.template_blocked(s, er, en, B), device)
    n = B * STRUCTURES[s].n_nodes
    E = lay["src_local"].shape[0]
    n_chunks = lay["chunk_dst_blk"].shape[0]
    n_real = int(lay["part_ptr"][-1])
    for d in WIDE_K6:
        basis = torch.randn((bb, d, d), generator=gen, device=device) \
            / d ** 0.5
        coeff = torch.randn((R, bb), generator=gen, device=device)
        x = torch.randn((n, d), generator=gen, device=device)
        g = torch.randn((n, d), generator=gen, device=device)
        basis_t = basis.transpose(1, 2)
        with torch.no_grad():
            got = rb.messages_blocked(x, basis, coeff, lay, R)
            got2 = rb.messages_blocked(x, basis, coeff, lay, R)
            got_t = rb.messages_blocked(g, basis_t, coeff, t_lay, R)
            got_t2 = rb.messages_blocked(g, basis_t, coeff, t_lay, R)
            got_g = rb.grad_blocked_parts(x, g, basis, coeff, lay, R)
            got_g2 = rb.grad_blocked_parts(x, g, basis, coeff, lay, R)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all())
                         for t in (got, got_t, *got_g))
            ga, _ = k6a_check(rb, got, got2, x, basis, coeff, lay, R, n)
            gt, _ = k6a_check(rb, got_t, got_t2, g, basis_t, coeff, t_lay,
                              R, n)
            plain_g = rb.grad_blocked_reference_parts(x, g, basis, coeff,
                                                      lay, R)
            s_bound = rb.grad_s_bound(x, g, basis, lay)
            gb = rb.k6b_gate(got_g, plain_g, s_bound, lay["rel"], R)
            gb["repeat_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(got_g, got_g2))
            r = int(lay["edges"][0, 2])
            cut_lay = dict(lay, norm=torch.where(lay["rel"] == r, 0.0,
                                                 lay["norm"]))
            bad = rb.k6b_gate(got_g, rb.grad_blocked_reference_parts(
                x, g, basis, coeff, cut_lay, R), s_bound, lay["rel"], R)
            gb["control_fails"] = not bad["dbasis_ok"] and \
                not bad["dcoeff_ok"]
        line = f"kernel.rgcn_blocked.wide {s} B={B} d={d} bases={bb} E={E} "
        for tag, gate in (("K6a", ga), ("K6a_t", gt)):
            line += (f"{tag}: flip_share={gate['flip_share']:.3e} "
                     f"rel_err={gate['rel_err']:.3e} "
                     f"diff_over_bound={gate['bound_ratio']:.3e} "
                     f"control_fails={gate['control_fails']} "
                     f"repeat_equal={gate['repeat_equal']} ")
        line += (f"K6b: dbasis_err={gb['dbasis_err']:.3e} "
                 f"s_flip_share={gb['s_flip_share']:.3e} "
                 f"s_beyond_neighbour={gb['s_beyond_neighbour']} "
                 f"dcoeff_err={gb['dcoeff_err']:.3e} "
                 f"control_fails={gb['control_fails']} "
                 f"repeat_equal={gb['repeat_equal']}")
        if not finite or not all(
                gate["ok"] and gate["control_fails"] and gate["repeat_equal"]
                for gate in (ga, gt, gb)):
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        del got2, got_t2, got_g2, plain_g, s_bound, got, got_t, got_g
        for kid, grad, kfn, names in (
                ("K6a", False,
                 lambda: rb.messages_blocked(x, basis, coeff, lay, R),
                 K6A_KERNELS),
                ("K6b", True,
                 lambda: rb.grad_blocked(x, g, basis, coeff, lay, R),
                 K6B_KERNELS)):
            with torch.no_grad():
                ms = time_ms(kfn, ITERS, flush)
                k_ms = device_ms(kfn, ITERS, flush, names)
            work = k6_work(E, n_chunks, n_real, n, d, d, bb, R, grad)
            t_b, t_o = bound_times(work)
            log(f"kernel.rgcn_blocked.wide {kid} {s} B={B} d={d} "
                f"kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
                f"bound_ms={max(t_b, t_o):.6f} "
                f"({'bytes' if t_b >= t_o else 'operations'})")
        del x, g, basis, coeff, basis_t


# ----------------------------------------------------------------------
# K4a / K4b (segment sum and max) and K7 (SDDMM)
# ----------------------------------------------------------------------
K4_KERNELS = ("segment_kernel",)  # the reduce, not the layout kernels
K4L_KERNELS = ("segment_layout",)  # the layout: one kernel, or three
K7_KERNELS = ("sddmm_kernel",)
EVAL_BATCH = 1024  # evaluate's bucket for its 1,000 queries per formula
CAP_ROWS, CAP_SEGMENTS = 1 << 20, 8192  # K4's cap: 512 MiB of f32 rows
K7_CAP_NODES = 8191


def k4_work(E: int, d: int, S: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one K4 call from the ids: the f32
    rows and the int32 ids read once, the [S, d] f32 output written once;
    one add (or compare) per input element."""
    return E * d * 4 + E * 4 + S * d * 4, 0, E * d


def k4_given_work(E: int, d: int, S: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one K4 launch on a given layout:
    the rows, perm [E] and offs [S + 1] (int32) read once, the output
    written once; one add (or compare) per input element."""
    return E * d * 4 + E * 4 + (S + 1) * 4 + S * d * 4, 0, E * d


def layout_work(E: int, S: int, id_bytes: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one layout: the ids read once, perm
    [E] and offs [S + 1] (int32) written once; integer work only."""
    return E * id_bytes + E * 4 + (S + 1) * 4, 0, 0


def bound_of(work) -> tuple:
    t_b, t_o = bound_times(work)
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def k7_work(N: int, d: int, E: int, same: bool = False) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP) of one K7 launch: x and y once (one
    read when ``same``, y being x), the int32 src and dst and the f32
    scores (12 E bytes); 2 E d f32 FLOP."""
    return (1 if same else 2) * N * d * 4 + 12 * E, 0, 2 * E * d


def sddmm_pattern(x, src, dst, check: bool):
    """The CSR pattern of the unique in-range (src, dst) pairs, sorted by
    row (``torch.unique``, ``bincount``, ``cumsum``), and its rows and
    columns."""
    n = x.shape[0]
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    key = torch.unique(src[ok].long() * n + dst[ok].long())
    rows, cols = key // n, key % n
    crow = torch.zeros(n + 1, dtype=torch.int32, device=x.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    pattern = torch.sparse_csr_tensor(
        crow, cols.to(torch.int32), torch.zeros(key.numel(), device=x.device),
        (n, n), check_invariants=check)
    return pattern, rows, cols


def sddmm_library(x, y, src, dst):
    """K7's library yardstick: ``torch.sparse.sampled_addmm`` over the CSR
    pattern of :func:`sddmm_pattern`.  Returns (the call with its pattern
    built here, outside it; the call that builds its pattern itself; the
    pattern's rows and columns)."""
    pattern, rows, cols = sddmm_pattern(x, src, dst, True)
    yt = y.t()

    def with_build():
        p, _, _ = sddmm_pattern(x, src, dst, False)
        return torch.sparse.sampled_addmm(p, x, yt, beta=0.0)

    return (lambda: torch.sparse.sampled_addmm(pattern, x, yt, beta=0.0),
            with_build, rows, cols)


def eval_batches(cfg, gen_np, capacity_pad: int = 0):
    """(structure, SparseQueryBatch) of every structure at EVAL_BATCH
    random queries, flattened by ``dense_to_sparse`` (``capacity_pad``
    padding edges, whose dst lies out of range)."""
    from mpqe_tpu_torch.data.batcher import (DenseQueryBatch,
                                             dense_to_sparse,
                                             template_edge_norm)
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    B = EVAL_BATCH
    for s in STRUCTURE_NAMES:
        spec = STRUCTURES[s]
        rels = gen_np.integers(0, cfg.n_rels, spec.n_edges).astype(np.int32)
        b = DenseQueryBatch(
            s, B, gen_np.integers(0, cfg.n_entities, (B, spec.n_nodes)
                                  ).astype(np.int32),
            gen_np.integers(0, cfg.n_modes, (B, spec.n_nodes)
                            ).astype(np.int32),
            rels, template_edge_norm(spec, rels), np.zeros(B, np.int32),
            np.zeros((B, 1), np.int32), np.ones((B, 1), np.float32),
            np.ones(B, np.float32))
        yield s, dense_to_sparse(b, cfg.n_rels,
                                 B * spec.n_edges + capacity_pad)


def segment_cases(cfg, device):
    """(label, data, ids, S) for K4: (i) the reference's chip check
    (tools/tpu_smoke.py:39-53) with some ids out of range and segment 7
    emptied, (ii) each structure's destination sum at EVAL_BATCH (the
    flattened batch's edge dst, 64 padding edges out of range; the data
    random rows), (iii) the cap, E = 2^20 random ids over 8,192 segments
    with some out of range and segment 7 emptied."""
    rng = np.random.default_rng(11)
    d = cfg.embed_dim

    def t(a):
        return torch.from_numpy(a).to(device)

    def knocked(E, S):
        ids = rng.integers(0, S, E).astype(np.int32)
        ids[ids == 7] = S + 1
        bad = rng.choice(E, max(E // 100, 4), replace=False)
        ids[bad[::2]] = -1
        ids[bad[1::2]] = S
        return ids

    yield "tpu_smoke", t(rng.normal(size=(1000, d)).astype(np.float32)), \
        t(knocked(1000, 64)), 64
    for s, sb in eval_batches(cfg, rng, capacity_pad=64):
        E = sb.edges.capacity
        yield s, t(rng.normal(size=(E, d)).astype(np.float32)), \
            t(sb.edges.dst), sb.n_nodes
    yield "cap", torch.randn((CAP_ROWS, d), device=device,
                             generator=torch.Generator(device).manual_seed(3)), \
        t(knocked(CAP_ROWS, CAP_SEGMENTS)), CAP_SEGMENTS


def phase_segment(cfg, device, flush):
    """The layout kernel against the plain layout (equal, and equal again
    on a repeat launch); K4a and K4b, with the layout built in the call
    and with it given, against their plain versions (K4a <= TOL_PLAIN and
    equal with and without a given layout, K4b exactly equal), K4a
    against an f64 oracle (<= TOL_ORACLE), the out-of-range and
    empty-segment semantics.  Times (CUDA events and profiler, L2
    flushed) of each kernel with its layout built and given, and of the
    layout alone, beside the bound, the plain version and the library
    yardstick (one ``index_add_``, one ``scatter_reduce`` amax; for the
    layout one stable ``torch.argsort`` of the ids with out-of-range ids
    mapped to S, which gives ``perm`` but not ``offs``).  Returns the
    JSON fields (launches excluded) of K4a, K4b (layout given) and the
    layout: sums over the 7 structures' destination sums at EVAL_BATCH."""
    from mpqe_tpu_torch.ops import segment_kernels as sk

    accs = {k: new_acc() for k in ("K4a", "K4b", "K4a.built", "K4b.built",
                                   "layout")}
    for label, data, ids, S in segment_cases(cfg, device):
        E, d = data.shape
        with torch.no_grad():
            layout = sk.segment_layout(ids, S)
            again = sk.segment_layout(ids, S)
            plain_layout = sk.segment_layout_reference(ids, S)
            got_s = sk.segment_sum_kernel(data, ids, S)
            got_m = sk.segment_max_kernel(data, ids, S)
            given_s = sk.segment_sum_kernel(data, ids, S, layout=layout)
            given_m = sk.segment_max_kernel(data, ids, S, layout=layout)
            plain_s = sk.segment_sum_reference(data, ids, S)
            plain_m = sk.segment_max_reference(data, ids, S)
        ok = (ids >= 0) & (ids < S)
        ids_ok, data_ok = ids[ok].long(), data[ok]
        oracle = torch.zeros((S, d), dtype=torch.float64, device=device)
        oracle.index_add_(0, ids_ok, data_ok.double())
        torch.cuda.synchronize()
        empty = torch.bincount(ids_ok, minlength=S) == 0
        lay_same = all(torch.equal(a, b) for a, b in zip(layout,
                                                         plain_layout))
        lay_repeat = all(torch.equal(a, b) for a, b in zip(layout, again))
        given_same = torch.equal(given_s, got_s) and torch.equal(given_m,
                                                                 got_m)
        e_s, e_m = rel_err(got_s, plain_s), rel_err(got_m, plain_m)
        e_orc = float((got_s.double() - oracle).abs().max()
                      / oracle.abs().max())
        same_m = torch.equal(got_m, plain_m)
        sem = (bool((got_s[empty] == 0).all())
               and bool((got_m[empty] == sk.NEG_INF).all())
               and bool(torch.isfinite(got_s).all()))
        for kid, got, plain in (("K4a", got_s, plain_s),
                                ("K4b", got_m, plain_m)):
            err = float((got - plain).abs().max())
            for key in (kid, f"{kid}.built"):
                accs[key]["max_abs_err"] = max(accs[key]["max_abs_err"], err)
        line = (f"kernel.segment {label:14s} E={E} S={S} "
                f"layout_equal_plain={lay_same} "
                f"layout_repeat_equal={lay_repeat} "
                f"given_layout_equal={given_same} "
                f"K4a_err_vs_plain={e_s:.3e} K4b_err_vs_plain={e_m:.3e} "
                f"K4a_err_vs_f64_oracle={e_orc:.3e} "
                f"dropped={int((~ok).sum())} empty={int(empty.sum())}")
        if (e_s > TOL_PLAIN or not same_m or e_orc > TOL_ORACLE or not sem
                or not (lay_same and lay_repeat and given_same)):
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        del plain_s, plain_m, oracle, again, plain_layout
        big = E > 100_000
        iters, p_iters = (BIG_ITERS, 1) if big else (ITERS, PLAIN_ITERS)
        idx = ids_ok[:, None].expand(-1, d)
        key = torch.where(ok, ids.long(), S)
        both = K4_KERNELS + K4L_KERNELS
        lib_s = lambda: torch.zeros((S, d), device=device).index_add_(  # noqa
            0, ids_ok, data_ok)
        lib_m = lambda: torch.full(  # noqa: E731
            (S, d), sk.NEG_INF, device=device).scatter_reduce_(
                0, idx, data_ok, "amax")
        cases = (
            # (accumulator, kernel call, profiler names, plain call,
            #  library call, work)
            ("K4a.built", lambda: sk.segment_sum_kernel(data, ids, S), both,
             lambda: sk.segment_sum_reference(data, ids, S), lib_s,
             k4_work(E, d, S)),
            ("K4a", lambda: sk.segment_sum_kernel(data, ids, S,
                                                  layout=layout),
             K4_KERNELS,
             lambda: sk.segment_sum_reference(data, ids, S, layout=layout),
             lib_s, k4_given_work(E, d, S)),
            ("K4b.built", lambda: sk.segment_max_kernel(data, ids, S), both,
             lambda: sk.segment_max_reference(data, ids, S), lib_m,
             k4_work(E, d, S)),
            ("K4b", lambda: sk.segment_max_kernel(data, ids, S,
                                                  layout=layout),
             K4_KERNELS,
             lambda: sk.segment_max_reference(data, ids, S, layout=layout),
             lib_m, k4_given_work(E, d, S)),
            ("layout", lambda: sk.segment_layout(ids, S), K4L_KERNELS,
             lambda: sk.segment_layout_reference(ids, S),
             lambda: torch.argsort(key, stable=True),
             layout_work(E, S, ids.element_size())))
        for kid, kfn, names, pfn, lfn, work in cases:
            with torch.no_grad():
                ms = time_ms(kfn, iters, flush)
                k_ms = device_ms(kfn, iters, flush, names)
                plain_ms = time_ms(pfn, p_iters, flush)
                lib_ms = time_ms(lfn, iters, flush)
            if label in ("tpu_smoke", "cap"):
                bound, by = bound_of(work)
            else:
                bound, by = add_case(accs[kid], ms, plain_ms, lib_ms, work,
                                     k_ms)
            log(f"kernel.segment {kid:9s} {label:14s} E={E} S={S} "
                + work_line(ms, k_ms, plain_ms, lib_ms, bound, by, work))
        del data, ids, got_s, got_m, given_s, given_m, data_ok, idx, key
        del layout
    fields = {}
    for kid, acc in accs.items():
        log(f"kernel.segment {kid} sum of 7 at B={EVAL_BATCH}: "
            f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} "
            f"library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.6f}")
        fields[kid] = finish_acc(acc)
    for kid in ("K4a", "K4b"):
        fields[kid]["built_ms"] = fields.pop(f"{kid}.built")["ms"]
    return fields


def final_layer_nodes(model, cfg, sb, device):
    """The node embeddings after the last R-GCN layer of a sparse batch
    (``encode_sparse``'s layers, K4a destination sums over one layout),
    ``[N, d]``."""
    from mpqe_tpu_torch.models import embeddings as emb_mod
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import segment_kernels as sk

    def t(a):
        return torch.from_numpy(a).to(device)

    e = sb.edges
    with torch.no_grad():
        x = emb_mod.embed_nodes_sparse(model.emb, t(sb.node_entity),
                                       t(sb.node_mode), t(sb.node_is_var))
        dst = t(e.dst)
        layout = sk.segment_layout(dst, x.shape[0])
        for li, lp in enumerate(model.layers):
            x = rgcn_ops.rgcn_sparse(x, lp, t(e.src), dst, t(e.rel),
                                     t(e.norm), cfg.n_rels,
                                     segment_backend="pallas", layout=layout)
            if li < len(model.layers) - 1:
                x = torch.relu(x)
    return x


def phase_sddmm(model, cfg, device, flush):
    """K7 against its plain version (equal: the same sum order) and an f64
    oracle (<= TOL_ORACLE), out-of-range endpoints scoring 0, times beside
    the bound, the plain version and the library yardstick
    (``torch.sparse.sampled_addmm``, see :func:`sddmm_library`).
    K7 has no caller in the package: its main-path drive is the scoring of
    the 7 structures' final-layer node embeddings at EVAL_BATCH over their
    own edges, counted from 0.  Returns (launches of that drive, the JSON
    fields: sums over those 7)."""
    from mpqe_tpu_torch.ops import sddmm as sd

    d = cfg.embed_dim
    rng = np.random.default_rng(12)
    gen = torch.Generator(device).manual_seed(4)

    def t(a):
        return torch.from_numpy(a).to(device)

    def rand_case(n, E):
        x = torch.randn((n, d), device=device, generator=gen)
        y = torch.randn((n, d), device=device, generator=gen)
        return x, y, t(rng.integers(0, n, E).astype(np.int32)), \
            t(rng.integers(0, n, E).astype(np.int32))

    batches = [(s, final_layer_nodes(model, cfg, sb, device), sb)
               for s, sb in eval_batches(cfg, rng)]
    sd.sddmm_kernel.launches = 0
    with torch.no_grad():
        for _, x, sb in batches:
            sd.sddmm_kernel(x, x, t(sb.edges.src), t(sb.edges.dst))
    torch.cuda.synchronize()
    launches = sd.sddmm_kernel.launches
    log(f"kernel.sddmm: the 7 batches' edges at B={EVAL_BATCH} scored by "
        f"K7: launches {launches}")
    if launches != len(batches):
        raise AssertionError(f"K7 launches {launches} != {len(batches)}")
    cases = [("tpu_smoke", *rand_case(512, 2048))]
    cases += [(s, x, x, t(sb.edges.src), t(sb.edges.dst))
              for s, x, sb in batches]
    cases.append(("cap", *rand_case(K7_CAP_NODES, CAP_ROWS)))
    acc = new_acc()
    for label, x, y, src, dst in cases:
        n, E = x.shape[0], src.shape[0]
        src, dst = src.clone(), dst.clone()
        src[:3] = torch.tensor([-1, n, 3 * n], device=device)
        dst[3] = n + 5  # four edges out of range: they score 0
        with torch.no_grad():
            got = sd.sddmm_kernel(x, y, src, dst)
            plain = sd.sddmm_reference(x, y, src, dst)
            oracle = sd.sddmm_xla(x.double(), y.double(), src, dst)
        torch.cuda.synchronize()
        e_plain = rel_err(got, plain)
        equal = bool(torch.equal(got, plain))
        e_orc = float((got.double() - oracle).abs().max()
                      / oracle.abs().max())
        zero = bool((got[:4] == 0).all())
        acc["max_abs_err"] = max(acc["max_abs_err"], float(
            (got - plain).abs().max()))
        line = (f"kernel.sddmm {label:14s} N={n} E={E} "
                f"err_vs_plain={e_plain:.3e} equal_plain={equal} "
                f"err_vs_f64_oracle={e_orc:.3e} out_of_range_zero={zero}")
        if not equal or e_orc > TOL_ORACLE or not zero or \
                not bool(torch.isfinite(got).all()):
            log(line + " FAIL")
            raise AssertionError(line)
        log(line)
        big = E > 100_000
        iters, p_iters = (BIG_ITERS, 1) if big else (ITERS, PLAIN_ITERS)
        lfn, lfn_built, rows, cols = sddmm_library(x, y, src, dst)
        with torch.no_grad():
            lib = lfn().values()
            lib_orc = sd.sddmm_xla(x.double(), y.double(), rows, cols)
            e_lib = float((lib.double() - lib_orc).abs().max()
                          / lib_orc.abs().max())
            ms = time_ms(lambda: sd.sddmm_kernel(x, y, src, dst), iters, flush)
            k_ms = device_ms(lambda: sd.sddmm_kernel(x, y, src, dst), iters,
                             flush, K7_KERNELS)
            plain_ms = time_ms(lambda: sd.sddmm_reference(x, y, src, dst),
                               p_iters, flush)
            lib_ms = time_ms(lfn, iters, flush)
            lib_built_ms = time_ms(lfn_built, iters, flush)
        work = k7_work(n, d, E, same=y is x)
        if label in ("tpu_smoke", "cap"):
            t_b, t_o = bound_times(work)
            bound, by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        else:
            bound, by = add_case(acc, ms, plain_ms, lib_ms, work, k_ms)
        log(f"kernel.sddmm {label:14s} N={n} E={E} kernel_ms={ms:.4f} "
            f"device_ms={k_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (sampled_addmm, {rows.numel()} pairs, "
            f"err_vs_f64_oracle={e_lib:.3e}; with its pattern built in the "
            f"call {lib_built_ms:.4f}) "
            f"bound_ms={bound:.6f} ({by}: {work[0]} B, {work[2]} f32 FLOP)")
        del got, plain, oracle, lib, lib_orc, lfn, lfn_built
    log(f"kernel.sddmm sum of 7 at B={EVAL_BATCH}: kernel_ms={acc['ms']:.4f} "
        f"device_ms={acc['device_ms']:.4f} plain_ms={acc['plain_ms']:.4f} "
        f"library_ms={acc['library_ms']:.4f} "
        f"bound_ms={acc['bound_ms']:.6f}")
    return launches, finish_acc(acc)


class SparseEncode:
    """``evaluate``'s ``encode_fn`` through the sparse path:
    ``dense_to_sparse``, then ``encode_sparse(segment_backend="pallas")``
    (K4a in every layer's destination sum and the sum / mlp readouts, K4b
    in the max readout, over one layout of the destinations and one of the
    readout's query ids).  Counts the K4 launches its calls should
    make."""

    def __init__(self):
        self.want = {"K4a": 0, "K4b": 0, "layout": 0}
        self.calls = 0

    def __call__(self, model, cfg, structure, ne, nm, er, en):
        from mpqe_tpu_torch.data.batcher import (DenseQueryBatch,
                                                 dense_to_sparse)
        from mpqe_tpu_torch.models import mpqe as mpqe_mod

        B, dev = ne.shape[0], ne.device
        z = np.zeros(B, np.int32)
        b = DenseQueryBatch(structure, B,
                            *(a.cpu().numpy() for a in (ne, nm, er, en)),
                            z, z[:, None], np.ones((B, 1), np.float32),
                            np.ones(B, np.float32))
        sb = dense_to_sparse(b, cfg.n_rels)
        e = sb.edges
        self.calls += 1
        steps = mpqe_mod.num_steps(cfg, structure)
        self.want["K4a"] += steps + (cfg.readout in ("sum", "mlp"))
        self.want["K4b"] += cfg.readout == "max"
        self.want["layout"] += (steps > 0) + (
            cfg.readout in ("sum", "mlp", "max"))
        return mpqe_mod.encode_sparse(
            model, cfg, structure,
            *(torch.from_numpy(a).to(dev) for a in (
                sb.node_entity, sb.node_mode, sb.node_is_var, e.src, e.dst,
                e.rel, e.norm, sb.node_query, sb.target_node)), B,
            segment_backend="pallas")


def k4_counters():
    from mpqe_tpu_torch.ops import segment_kernels as sk

    return {"K4a": sk.segment_sum_kernel, "K4b": sk.segment_max_kernel,
            "layout": sk.segment_layout}


def recheck_eval_formulas(model, cfg, val_q, device, label):
    """One formula per structure (its largest) encoded through the sparse
    path with the kernels and with their plain versions: bit-equal query
    vectors."""
    from mpqe_tpu_torch.data.batcher import bucket_size, make_dense_batch

    enc = SparseEncode()
    for structure, by_formula in val_q.items():
        formula, qs = max(by_formula.items(), key=lambda kv: len(kv[1]))
        b = make_dense_batch(formula, qs[:1000], bucket_size(len(qs[:1000])),
                             n_neg=64, rng=np.random.default_rng(0))
        args = [torch.from_numpy(getattr(b, f)).to(device) for f in (
            "node_entity", "node_mode", "edge_rel", "edge_norm")]
        with torch.no_grad():
            q_k = enc(model, cfg, structure, *args)
            with plain_sparse_kernels():
                q_p = enc(model, cfg, structure, *args)
        torch.cuda.synchronize()
        same = torch.equal(q_k, q_p)
        line = (f"{label}.recheck {structure:14s} B={b.batch_size} "
                f"query_vectors_bit_equal={same} "
                f"max_abs_diff={float((q_k - q_p).abs().max()):.3e}")
        log(line)
        if not same or not bool(torch.isfinite(q_k).all()):
            raise AssertionError(line)


def eval_sparse_run(model, cfg, val_q, device, label, profile=False):
    """``evaluate`` on ``val_q`` through :class:`SparseEncode` (K4 launch
    counts from 0 must equal the expected counts) and through the f32
    ``encode_dense``: per-structure AUC and APR / 100 within 1e-3; with
    ``profile``, a device profile of the sparse run on one structure.
    Returns the K4 launches of the sparse run."""
    from mpqe_tpu_torch.train import evaluation

    enc = SparseEncode()
    counters = k4_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = evaluation.evaluate(model, cfg, val_q, n_neg=64, encode_fn=enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_q = sum(min(len([q for q in qs if q.neg_samples]), 1000)
              for by_f in val_q.values() for qs in by_f.values())
    log(f"{label}: evaluate through the sparse path (readout "
        f"{cfg.readout}): {enc.calls} encode calls, {n_q} queries in "
        f"{wall:.3f} s ({n_q / wall:.1f} queries/s); launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" (expected {' '.join(f'{k}={v}' for k, v in enc.want.items())})")
    if launches != enc.want or launches["K4a"] == 0 or \
            launches["layout"] == 0:
        raise AssertionError(f"{label}: launches {launches} != {enc.want}")
    t0 = time.perf_counter()
    dense = evaluation.evaluate(model, cfg, val_q, n_neg=64)
    torch.cuda.synchronize()
    log(f"{label}: evaluate through encode_dense (f32) "
        f"{time.perf_counter() - t0:.3f} s")
    worst = 0.0
    for name, scale in (("auc_by_structure", 1.0), ("apr_by_structure", 100.0),
                        ("hard_auc_by_structure", 1.0)):
        a, b = getattr(res, name), getattr(dense, name)
        if set(a) != set(b):
            raise AssertionError(f"{label}: {name} keys differ")
        for s in a:
            worst = max(worst, abs(a[s] - b[s]) / scale)
    line = (f"{label}: sparse vs dense evaluate: macro_auc "
            f"{res.macro_auc:.6f} vs {dense.macro_auc:.6f}, macro_apr "
            f"{res.macro_apr:.4f} vs {dense.macro_apr:.4f}; worst "
            f"per-structure |diff| (AUC, APR / 100) {worst:.3e}")
    log(line)
    if worst > 1e-3:
        raise AssertionError(line)
    recheck_eval_formulas(model, cfg, val_q, device, label)
    if profile:
        part = {"3-chain_inter": val_q["3-chain_inter"]}
        profile_device(f"{label}.profile (3-chain_inter formulas)",
                       lambda: evaluation.evaluate(model, cfg, part, n_neg=64,
                                                   encode_fn=SparseEncode()),
                       also=K4_KERNELS + K4L_KERNELS)
    return launches


def phase_eval_sparse(model, cfg, kg, train_q, val_q, device):
    """The per-formula evaluation through the sparse path on the flagship
    model (TGT readout: K4a) and a flagship-width max-readout model (K4a
    and K4b), then ``run_train`` for 20 dense steps with one validation
    round through ``eval_encode_fn``.  Returns the K4 launches of these
    runs."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    total = eval_sparse_run(model, cfg, val_q, device, "eval.sparse",
                            profile=True)
    mcfg = mpqe_mod.MPQEConfig(**dict(FLAGSHIP, readout="max"))
    gen = torch.Generator(device=device).manual_seed(6)
    mmodel = mpqe_mod.init_mpqe(gen, mcfg, device=device)
    for k, v in eval_sparse_run(mmodel, mcfg, val_q, device,
                                "eval.sparse_max").items():
        total[k] += v
    del mmodel

    tc = loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                              max_steps=20, val_every=20,
                              burn_in_structure="none", seed=0)
    gen = torch.Generator(device=device).manual_seed(7)
    state = loop_mod.init_train_state(gen, cfg, tc, device=device)
    enc = SparseEncode()
    counters = k4_counters()
    for fn in counters.values():
        fn.launches = 0
    records = []
    t0 = time.perf_counter()
    loop_mod.run_train(state, cfg, tc, train_q, val_queries=val_q,
                       log_fn=records.append, eval_encode_fn=enc, kg=kg)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    vals = [r for r in records if "val" in r]
    log(f"eval.sparse.train: {state.step} dense steps and {len(vals)} "
        f"validation round through eval_encode_fn in "
        f"{time.perf_counter() - t0:.2f} s; launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" (expected {' '.join(f'{k}={v}' for k, v in enc.want.items())})"
        f"; val macro_auc "
        f"{vals[-1]['val']['auc_macro'] if vals else float('nan'):.4f}")
    if len(vals) != 1 or launches != enc.want or launches["K4a"] == 0 or \
            launches["layout"] == 0:
        raise AssertionError(f"eval.sparse.train: {len(vals)} rounds, "
                             f"launches {launches} != {enc.want}")
    for k, v in launches.items():
        total[k] += v
    return total


def phase_eval_ranking(model, cfg, kg, val_q, device):
    """``full_ranking`` on the flagship model over ``val_q`` (every
    entity of the target's mode, 1M entities); one structure's ranks
    recomputed by ``torch.matmul`` and a per-row count must give the same
    metrics."""
    from mpqe_tpu_torch.data.batcher import bucket_size
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops.fused_fwd import prepare_fused_multi
    from mpqe_tpu_torch.train import evaluation

    t0 = time.perf_counter()
    rk = evaluation.full_ranking(model, cfg, val_q, kg.entity_mode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for s, m in rk.items():
        log(f"eval.ranking {s:14s} " + " ".join(
            f"{k}={v:.6f}" for k, v in m.items()))
    es = evaluation.make_eval_set(val_q, 200, require_negatives=False)
    n_q = sum(d["target"].shape[0] for d in es.by_structure.values())
    log(f"eval.ranking: {n_q} queries against {cfg.n_entities} entities in "
        f"{wall:.3f} s ({n_q / wall:.1f} queries/s)")
    structure = "3-chain_inter"
    data = es.by_structure[structure]
    n = data["target"].shape[0]
    B = bucket_size(n)
    pad = [evaluation._pad_chunk(data[k], 0, n, B, device, fill)
           for k, fill in (("node_entity", 0), ("node_mode", 0),
                           ("edge_rel", 0), ("edge_norm", 1))]
    emode = torch.from_numpy(kg.entity_mode.astype(np.int32)).to(device)
    with torch.no_grad():
        q = mpqe_mod.encode_dense_multi_auto(
            model, cfg, structure, *pad,
            operands=prepare_fused_multi(model, cfg))
        e = mpqe_mod._l2_normalize(model.emb.ent)
        scores = torch.matmul(mpqe_mod._l2_normalize(q), e.t())
    ranks = []
    for i, t in enumerate(data["target"].tolist()):
        row = scores[i]
        ranks.append(1 + int(((row > row[t]) & (emode == emode[t])).sum()))
    want = evaluation._rank_metrics(np.asarray(ranks, np.float64),
                                    (1, 3, 10))
    line = (f"eval.ranking.recheck {structure}: {n} ranks recomputed by "
            f"torch.matmul and a per-row count: equal={want == rk[structure]}")
    log(line)
    if want != rk[structure]:
        raise AssertionError(f"{line}: {want} != {rk[structure]}")


def phase_eval_cli(run_dir: str) -> None:
    """``python -m mpqe_tpu_torch.evaluate --run_dir <run_dir> --ranking``
    as a subprocess: its lines (one metrics line, one per structure)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpqe_tpu_torch.evaluate", "--run_dir",
         run_dir, "--ranking"], capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    log(f"eval.cli: rc={proc.returncode} {time.perf_counter() - t0:.2f} s, "
        f"{len(lines)} lines")
    for ln in lines:
        log(f"eval.cli: {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"evaluate CLI failed:\n{proc.stderr[-4000:]}")
    head = json.loads(lines[0])
    ranks = [json.loads(ln) for ln in lines[1:]]
    if not {"checkpoint", "step", "use", "auc_macro", "apr_macro"} <= set(
            head) or head["step"] != 20 or not ranks or not all(
            "mrr" in r for r in ranks):
        raise AssertionError(f"unexpected evaluate CLI output {lines}")


def phase_serve_cli(run_dir: str) -> None:
    """``python -m mpqe_tpu_torch.serve --run_dir <run_dir>`` as a
    subprocess: it restores the run's latest checkpoint (step 20) over
    the KG rebuilt from the run's config and serves a sampled stream of
    every structure on the card."""
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpqe_tpu_torch.serve", "--run_dir",
         run_dir, "--requests", "21", "--batch", "8", "--structures",
         ",".join(STRUCTURE_NAMES)], capture_output=True, text=True,
        timeout=600)
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    log(f"serve.cli --run_dir: rc={proc.returncode} "
        f"{time.perf_counter() - t0:.2f} s: {last}")
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI failed:\n{proc.stderr[-4000:]}")
    out = json.loads(last)
    if not (str(out.get("checkpoint", "")).endswith("step_20")
            and out.get("device") == torch.cuda.get_device_name(0)
            and out.get("requests") == 21
            and np.isfinite(out.get("latency_ms_p50", np.nan))
            and 0.0 <= out.get("hit_at_k", -1.0) <= 1.0):
        raise AssertionError(f"unexpected serve CLI output {last!r}")


def _plain_k5a(x, src, basis, coeff, chunk_rel, n_rels, norm, chunk,
               w_transposed=False):
    """K5a's plain version under the wrapper's signature (``w_transposed``:
    the weights read transposed, as ``EdgeMessages.backward`` asks)."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    return rf.messages_basis_reference(
        x, src, basis.transpose(1, 2) if w_transposed else basis,
        rf._masked_chunk_coeff(coeff, chunk_rel, n_rels), norm, chunk)


def _plain_k5b(x, src, w_rel, chunk_rel, norm, chunk, w_transposed=False):
    """K5b's plain version under the wrapper's signature."""
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    return rf.messages_wrel_reference(
        x, src, w_rel.transpose(1, 2) if w_transposed else w_rel, chunk_rel,
        norm, chunk)


class plain_sparse_kernels:
    """Within the block, the K4, K5 and K6 wrappers that ``ops/segment.py``,
    ``encode_sparse`` (the K4 layout) and the autograd Functions of
    ``ops/rgcn_fused.py`` and ``ops/rgcn_blocked.py`` call are their plain
    versions, on the card (the train-step and eval.sparse rechecks)."""

    def __enter__(self):
        from mpqe_tpu_torch.ops import rgcn_blocked as rb
        from mpqe_tpu_torch.ops import rgcn_fused as rf
        from mpqe_tpu_torch.ops import segment_kernels as sk

        self.saved = (rf.messages_basis, rf.messages_wrel,
                      rb.messages_blocked, rb.grad_blocked,
                      sk.segment_sum_kernel, sk.segment_max_kernel,
                      sk.segment_layout)
        rf.messages_basis = _plain_k5a
        rf.messages_wrel = _plain_k5b
        rb.messages_blocked = lambda x, basis, coeff, lay, n_rels: \
            rb.messages_blocked_reference(x, basis, coeff, lay, n_rels,
                                          x.shape[0])
        rb.grad_blocked = rb.grad_blocked_reference
        sk.segment_sum_kernel = sk.segment_sum_reference
        sk.segment_max_kernel = sk.segment_max_reference
        sk.segment_layout = sk.segment_layout_reference
        return self

    def __exit__(self, *exc):
        from mpqe_tpu_torch.ops import rgcn_blocked as rb
        from mpqe_tpu_torch.ops import rgcn_fused as rf
        from mpqe_tpu_torch.ops import segment_kernels as sk

        (rf.messages_basis, rf.messages_wrel, rb.messages_blocked,
         rb.grad_blocked, sk.segment_sum_kernel, sk.segment_max_kernel,
         sk.segment_layout) = self.saved
        return False


SPARSE_RUNS = {
    # name: (kernel, num_bases, loss function name)
    "train.fused": ("fused", 16, "dense_batch_loss_kernel_fused"),
    "train.fused_full": ("fused", None, "dense_batch_loss_kernel_fused"),
    "train.blocked": ("blocked", 16, "dense_batch_loss_kernel_blocked"),
}


def sparse_counters():
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    return {"K5a": rf.messages_basis, "K5b": rf.messages_wrel,
            "K6a": rb.messages_blocked, "K6b": rb.grad_blocked}


def recheck_sparse_step(state, cfg, stores, device, loss_name, label):
    """One step per structure from the trained state through the kernels
    and through their plain versions on the card: same loss and gradients
    (<= TOL_PLAIN relative, per leaf; the segment sums and the dx scatter
    go through index_add_, whose atomics vary the last bits; for
    ``train.blocked`` the gradients per leaf in mean|diff| / mean|ref|)."""
    from mpqe_tpu_torch.data.store import pack_dense_batch_np
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    model = state.model
    params = dict(model.named_parameters())
    loss_fn = getattr(mpqe_mod, loss_name)
    for structure, f_stores in stores.items():
        fstore = max(f_stores, key=lambda f: f.n_queries)
        batch = pack_dense_batch_np(
            fstore, np.arange(min(fstore.n_queries, TRAIN_BATCH)),
            TRAIN_BATCH, 4, 11)
        t = loop_mod.batch_tensors(batch, device)
        loss_k = loss_fn(model, cfg, structure, *t)
        g_k = torch.autograd.grad(loss_k, list(params.values()),
                                  allow_unused=True)
        with plain_sparse_kernels():
            loss_p = loss_fn(model, cfg, structure, *t)
            g_p = torch.autograd.grad(loss_p, list(params.values()),
                                      allow_unused=True)
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        e_loss = abs(lk - lp) / max(abs(lp), 1e-12)
        gk, gp = dict(zip(params, g_k)), dict(zip(params, g_p))
        e_grad = tree_rel_err(gk, gp)
        line = (f"{label}.recheck {structure:14s} loss={lk:.6f} "
                f"loss_err={e_loss:.3e} grad_err={e_grad:.3e}")
        if label == "train.blocked":
            # K6 takes its products on the tensor cores: a message can
            # land one bf16 step from the plain one, and a ReLU mask
            # downstream can flip with it, so single gradient elements
            # move; held per leaf to mean|diff| / mean|ref|, the form K2's
            # check uses, with the max-element figure beside it
            e_max, e_grad = e_grad, tree_mean_err(gk, gp)
            line = (f"{label}.recheck {structure:14s} loss={lk:.6f} "
                    f"loss_err={e_loss:.3e} grad_mean_err={e_grad:.3e} "
                    f"grad_max_err={e_max:.3e}")
        log(line)
        if e_loss > TOL_PLAIN or e_grad > TOL_PLAIN or not np.isfinite(lk):
            raise AssertionError(line)


def phase_train_sparse(kg, train_q, device, label):
    """``run_train`` on the card through the sparse path of ``label``
    (:data:`SPARSE_RUNS`): launch counts equal to the expected counts,
    finite losses, the plain-version recheck, step p50/p95 and a profile.
    Returns the launches by kernel id."""
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES
    from mpqe_tpu_torch.train import loop as loop_mod

    kernel, nb, loss_name = SPARSE_RUNS[label]
    cfg = mpqe_mod.MPQEConfig(**dict(FLAGSHIP, num_bases=nb))
    tc = loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                              max_steps=SPARSE_STEPS, val_every=1 << 30,
                              burn_in_structure="none", seed=0)
    gen = torch.Generator(device=device).manual_seed(2)
    state = loop_mod.init_train_state(gen, cfg, tc, device=device)
    real = []
    loss_impl = getattr(mpqe_mod, loss_name)

    def loss_fn(*a):
        real.append(a[-1].sum())
        return loss_impl(*a)

    t0 = time.perf_counter()
    loop_mod.warmup_train_step(
        lambda opt: loop_mod.make_train_step(cfg, opt, loss_fn), cfg, tc,
        STRUCTURE_NAMES, device)
    torch.cuda.synchronize()
    log(f"{label}: setup: warmup (one throwaway step per structure) "
        f"{time.perf_counter() - t0:.2f} s")
    counters = sparse_counters()
    for fn in counters.values():
        fn.launches = 0
    real.clear()
    records = []
    t0 = time.perf_counter()
    loop_mod.run_train(state, cfg, tc, train_q, log_fn=records.append,
                       batch_loss_fn=loss_fn, kg=kg)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = [r for r in records if "loss" in r]
    losses = [r["loss"] for r in steps]
    # per step, each of the structure's num_steps layers launches K5 twice
    # (forward, dxs) or K6a twice (forward, dx) and K6b once
    layers = sum(mpqe_mod.num_steps(cfg, r["structure"]) for r in steps)
    if kernel == "fused":
        want = {"K5a": 2 * layers if nb else 0,
                "K5b": 0 if nb else 2 * layers, "K6a": 0, "K6b": 0}
    else:
        want = {"K5a": 0, "K5b": 0, "K6a": 2 * layers, "K6b": layers}
    log(f"{label}: {state.step} steps in {wall:.2f} s; launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" (expected {' '.join(f'{k}={v}' for k, v in want.items())}); "
        f"loss first={losses[0]:.6f} last={losses[-1]:.6f}")
    if len(losses) != SPARSE_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: {len(losses)} steps, finite: "
                             f"{all(np.isfinite(losses))}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want}")
    ms = np.asarray([r["seconds"] * 1e3 for r in steps])
    n_real = int(torch.stack(real).sum())
    log(f"{label}: {len(ms)} steps of batch {TRAIN_BATCH} on "
        f"{torch.cuda.get_device_name(device)}: "
        f"step_ms_p50={np.percentile(ms, 50):.3f} "
        f"step_ms_p95={np.percentile(ms, 95):.3f} "
        f"train_queries_per_s={n_real / ms.sum() * 1e3:.1f} "
        f"({n_real} real rows of {len(ms) * TRAIN_BATCH}) "
        f"padded_rows_per_s={len(ms) * TRAIN_BATCH / ms.sum() * 1e3:.1f}")
    stores = build_stores(train_q, kg=kg)
    recheck_sparse_step(state, cfg, stores, device, loss_name, label)
    ptc = dataclasses.replace(tc, max_steps=PROFILE_STEPS)
    profile_device(f"{label}.profile ({PROFILE_STEPS} steps)",
                   lambda: loop_mod.run_train(state, cfg, ptc, train_q,
                                              batch_loss_fn=loss_fn, kg=kg),
                   also=K5_KERNELS + K6A_KERNELS + K6B_KERNELS)
    return launches


# ----------------------------------------------------------------------
# K8 (the ring-halo R-GCN layer) and training through the halo layers
# ----------------------------------------------------------------------
K8_KERNELS = ("ring_sum_kernel", "ring_keys_kernel", "ring_bounds_kernel",
              "ring_runs_kernel", "ring_rows_kernel", "ring_dst_kernel",
              "k5_msg_kernel", "k5_combine_kernel")
RING_SIZES = (2, 3, 4, 8)
RING_TEMPLATE_PARTS = 4
RING_SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's clock, per aggregate
HALO_PARTS = 4
HALO_STEPS = 20


def k8_work(N: int, d: int, d_out: int, bb: int, n_rels: int, E: int,
            n_parts: int) -> tuple:
    """(bytes, bf16 FLOP, f32 FLOP, TF32 FLOP) of one K8 layer call (all P
    hops): x, the E real edges' src, dst, rel and norm (16 B each), the
    basis and coeff read once, the [N, d_out] aggregate written once; the
    least f32 work of three routes: per edge and basis (2 d d_out Bb an
    edge), per held source row (2 d d_out Bb for each of the P N rows a
    part holds over the ring), each plus the basis sum (2 Bb an output),
    the norm and the destination add; per relation (2 d d_out an edge,
    plus the combine, R Bb d d_out multiplies and adds, plus the norm and
    the add).  The TF32 entry is the per-relation route's products in
    split TF32 (3 x 2 d d_out an edge), which ``bound_times`` takes when
    it is faster, as for K5."""
    nbytes = (N * d * 4 + E * 16 + bb * d * d_out * 4 + n_rels * bb * 4
              + N * d_out * 4)
    tail = E * d_out * (2 * bb + 2)
    f32 = min(2 * d * d_out * bb * E + tail,
              2 * d * d_out * bb * n_parts * N + tail,
              2 * d * d_out * E + 2 * n_rels * bb * d * d_out
              + 2 * E * d_out)
    return nbytes, 0, f32, 3 * 2 * d * d_out * E


def k8_work_pr5(N: int, d: int, d_out: int, bb: int, n_rels: int, E: int,
                n_parts: int) -> tuple:
    """PR 5's count, printed beside: the cheaper of per edge and per held
    row (min(E, P N)), f32 only."""
    nbytes = k8_work(N, d, d_out, bb, n_rels, E, n_parts)[0]
    f32 = 2 * d * d_out * bb * min(E, n_parts * N) + E * d_out * (2 * bb + 2)
    return nbytes, 0, f32


def ring_cases(cfg, gen, device):
    """One dict per K8 case (label, P, mesh, x, the ring's edge arrays on
    the card, the single-device graph's (src, dst, rel, norm), its node
    and edge counts): the reference's general graph for every ring size
    (the same x), then each structure's template layout at TRAIN_BATCH
    on RING_TEMPLATE_PARTS parts."""
    from mpqe_tpu_torch.parallel import halo
    from mpqe_tpu_torch.parallel import halo_train as ht
    from mpqe_tpu_torch.parallel.mesh import make_mesh
    from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

    def t(a):
        return torch.from_numpy(a).to(device)

    st = general_store(cfg)
    m = st.pad_mask
    single = tuple(t(a[m]) for a in (st.src, st.dst, st.rel, st.norm))
    x0 = torch.randn((st.n_nodes, cfg.embed_dim), generator=gen,
                     device=device)
    for P in RING_SIZES:
        pr = halo.partition_edges_ring(st, P)
        x = torch.zeros((pr.n_nodes_padded, cfg.embed_dim), device=device)
        x[:st.n_nodes] = x0
        yield dict(label="general", P=P, x=x, n=st.n_nodes, E=int(m.sum()),
                   mesh=make_mesh((P, 1), devices=[device] * P),
                   edges=[t(a) for a in (pr.src_local, pr.dst_local, pr.rel,
                                         pr.norm)], single=single)
    B, P = TRAIN_BATCH, RING_TEMPLATE_PARTS
    for s in STRUCTURE_NAMES:
        spec = STRUCTURES[s]
        lay = ht._template_layout(s, B, P, "ring", device)
        er, en = template_rel_norm(gen, cfg, s)
        slot = lay["slot_ordered"]
        rel = torch.full((lay["total"],), cfg.n_rels, dtype=torch.int32,
                         device=device)
        rel[lay["flat"]] = er[slot]
        norm = torch.zeros((lay["total"],), device=device)
        norm[lay["flat"]] = en[slot]
        offs = torch.arange(B, device=device)[:, None] * spec.n_nodes
        src = (offs + torch.tensor(spec.edge_src, device=device)).reshape(-1)
        dst = (offs + torch.tensor(spec.edge_dst, device=device)).reshape(-1)
        yield dict(label=s, P=P, n=B * spec.n_nodes, E=B * spec.n_edges,
                   x=torch.randn((lay["n_pad"], cfg.embed_dim),
                                 generator=gen, device=device),
                   mesh=make_mesh((P, 1), devices=[device] * P),
                   edges=[lay["o_src"], lay["o_dst"],
                          rel.reshape(lay["shape"]),
                          norm.reshape(lay["shape"])],
                   single=(src, dst, er.repeat(B), en.repeat(B)))


def ring_device_ms(fn, iters: int, flush: torch.Tensor) -> tuple:
    """(K8's device ms, the copy stream's busy ms, its operations, the
    layouts' sort ms) per ``fn()`` call, each call after an L2 flush
    (torch.profiler): K8's kernels alone; every device operation on a
    stream that ran no K8 (the ring's copies; the slot set-up and the flush
    run on K8's stream); the ``torch.sort`` kernels on K8's stream."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        k8 = [e for e in dev if any(k in e.name for k in K8_KERNELS)]
        if k8:
            streams = {e.device_resource_id for e in k8}
            side = [e for e in dev if e.device_resource_id not in streams]
            sort = [e for e in dev if e.device_resource_id in streams
                    and "sort" in e.name.lower()]
            return (sum(e.time_range.elapsed_us() for e in k8) / iters / 1e3,
                    sum(e.time_range.elapsed_us() for e in side)
                    / iters / 1e3, len(side) // iters,
                    sum(e.time_range.elapsed_us() for e in sort)
                    / iters / 1e3)
        log(f"ring_device_ms: profile {attempt + 1} recorded no K8")
    raise AssertionError(f"the profiler saw no K8 in {PROFILE_TRIES} "
                         "profiles")


class delayed_receivers:
    """Within the block, every K8 launch is preceded on its stream by
    ``torch.cuda._sleep``: each receiver's aggregate runs late, and only
    the ack events keep the copy stream from overwriting a slot before it
    has been read."""

    def __enter__(self):
        from mpqe_tpu_torch.ops import ring

        self.saved = ring._launch_hop

        def late(*a):
            torch.cuda._sleep(RING_SLEEP_CYCLES)
            return self.saved(*a)

        ring._launch_hop = late
        return self

    def __exit__(self, *exc):
        from mpqe_tpu_torch.ops import ring

        ring._launch_hop = self.saved
        return False


def ring_library(c, layer, R: int):
    """K8's yardstick, several PyTorch calls (no single call computes
    K8): per hop one ``torch.bmm`` of the relation-chunked source rows by
    their relations' combined W and one ``index_add_`` of the messages
    into their destinations, on the operands of K8's own layouts gathered
    before the timing (as K5's yardstick)."""
    from mpqe_tpu_torch.ops import ring

    P, x = c["P"], c["x"]
    block = x.shape[0] // P
    devs = c["mesh"].axis_devices("data")
    g = ring._groups(devs, layer, x, c["edges"], block, R,
                     "plain")[devs[0]]
    rt, dev = g.route, x.device
    w = ring.combined_weights(g.basis, g.coeff)
    L, _, N = g.out.shape
    live = rt.live.tolist()
    hops = []
    for s_, nl in enumerate(live):
        if nl == 0:  # no edge reaches a part at this hop
            continue
        rows = nl * rt.chunk
        xs = g.comm_rows[rt.src[s_, :rows].long()].view(nl, rt.chunk,
                                                         x.shape[1])
        wc = w[rt.crel[s_, :nl].long()]
        drow, doffs = rt.drow[s_].long(), rt.doffs[s_].long()
        pos = torch.arange(drow.shape[1], device=dev).expand(L, -1)
        r = torch.searchsorted(doffs[:, 1:].contiguous(), pos.contiguous(),
                               right=True)
        ok = pos < doffs[:, -1:]
        dest = torch.zeros(rows + 1, dtype=torch.long, device=dev)
        at = torch.where(ok, drow, rows)
        dest[at.reshape(-1)] = (r + torch.arange(L, device=dev)[:, None]
                                * block).reshape(-1)
        hops.append((xs, wc, dest[:rows]))
    out = torch.zeros((L * block, N), device=dev)

    def fn():
        for xs, wc, dest in hops:
            out.index_add_(0, dest, torch.bmm(xs, wc).view(-1, N))

    return fn


def phase_ring(layer, cfg, device, gen, flush):
    """K8's drive (counted from 0: 6 + 2 P launches per layer call), then
    for each case K8 against its plain version and the f32 oracles, the
    port's ``rgcn_ring_halo`` and the single-device ``rgcn_sparse``, under
    ``ops/ring.py ring_gate``; its two negative controls (the plain version
    with one edge's rel changed, with one edge's src moved) failing it; a
    repeat and a run with delayed receivers equal to the first; times
    beside the bound (and PR 5's count of it), the copy stream's busy
    time, the plain version and the yardstick.  Returns (launches of the
    drive, the JSON fields: sums over the 7 template layouts)."""
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.parallel import halo

    d, R, bb = cfg.embed_dim, cfg.n_rels, layer.basis.shape[0]
    cases = list(ring_cases(cfg, gen, device))

    def k8(c):
        return ring.rgcn_ring_halo_rdma(c["mesh"], layer, c["x"],
                                        *c["edges"], R)

    ring.rgcn_ring_halo_rdma.launches = 0
    with torch.no_grad():
        outs = [k8(c) for c in cases]
    torch.cuda.synchronize()
    launches = ring.rgcn_ring_halo_rdma.launches
    want = sum(6 + 2 * c["P"] for c in cases)
    log(f"kernel.ring: launches {launches} in {len(cases)} layer calls "
        f"(expected {want}: 6 + 2 P per call)")
    if launches != want:
        raise AssertionError(f"K8 launches {launches} != {want}")
    acc = new_acc()
    general_ref = None
    for c, got in zip(cases, outs):
        label, P, x, edges, n = c["label"], c["P"], c["x"], c["edges"], c["n"]
        block = x.shape[0] // P
        with torch.no_grad():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            plain = ring.rgcn_ring_halo_rdma_reference(c["mesh"], layer, x,
                                                       *edges, R)
            b.record()
            xla = halo.rgcn_ring_halo(c["mesh"], layer, x, *edges, R)
            if label != "general" or general_ref is None:
                ref1 = rgcn_ops.rgcn_sparse(x[:n], layer, *c["single"], R)
                if label == "general":
                    general_ref = ref1
            else:  # the same graph and x at every ring size
                ref1 = general_ref
            again = k8(c)
            with delayed_receivers():
                late = k8(c)
            controls = [ring.rgcn_ring_halo_rdma_reference(
                c["mesh"], layer, x, *ce, R)
                for ce in ring.ring_controls(edges, R, block)]
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        gate = ring.ring_gate(got, plain, [(got, xla), (got[:n], ref1)])
        ctl = [ring.ring_gate(got, cp) for cp in controls]
        repeat, same_late = torch.equal(again, got), torch.equal(late, got)
        line = (f"kernel.ring {label:14s} P={P} N={x.shape[0]} E={c['E']} "
                f"gate_ok={gate['ok']} err_vs_plain="
                f"{gate['err_vs_plain']:.3e} err_vs_rgcn_ring_halo="
                f"{gate['err_vs_oracles'][0]:.3e} err_vs_rgcn_sparse="
                f"{gate['err_vs_oracles'][1]:.3e} controls_fail="
                f"{not any(g['ok'] for g in ctl)} (rel "
                f"{ctl[0]['err_vs_plain']:.3e}, src "
                f"{ctl[1]['err_vs_plain']:.3e}) repeat_equal={repeat} "
                f"delayed_receivers_equal={same_late}")
        if (not gate["ok"] or any(g["ok"] for g in ctl) or not repeat
                or not same_late):
            log(line + " FAIL")
            raise AssertionError(line)
        acc["max_abs_err"] = max(acc["max_abs_err"],
                                 float((got - plain).abs().max()))
        del plain, xla, late, again, controls
        devs = c["mesh"].axis_devices("data")
        with torch.no_grad():  # the layout kernels against ring_route
            lay_k, lay_p = (ring._groups(devs, layer, x, edges, block, R,
                                         kind)[devs[0]].route
                            for kind in ("kernel", "plain"))
        lay_ok = ring.route_matches(lay_k, lay_p)
        line += f" layout_equal_plain={lay_ok}"
        if not lay_ok:
            log(line + " FAIL")
            raise AssertionError(line)
        del lay_k, lay_p
        iters = BIG_ITERS if label == "general" else ITERS
        with torch.no_grad():
            ms = time_ms(lambda: k8(c), iters, flush)
            k_ms, copy_ms, n_copies, sort_ms = ring_device_ms(
                lambda: k8(c), iters, flush)
            lib_fn = ring_library(c, layer, R)
            lib_ms = time_ms(lib_fn, iters, flush)
            del lib_fn
        work = k8_work(x.shape[0], d, d, bb, R, c["E"], P)
        old = max(bound_times(k8_work_pr5(x.shape[0], d, d, bb, R, c["E"],
                                          P)))
        if label == "general":
            t_b, t_o = bound_times(work)
            bound, by = max(t_b, t_o), ("bytes" if t_b >= t_o
                                        else "operations")
        else:
            bound, by = add_case(acc, ms, plain_ms, lib_ms, work, k_ms)
        log(line + f" kernel_ms={ms:.4f} device_ms={k_ms:.4f} "
            f"sort_ms={sort_ms:.4f} "
            f"copy_stream_ms={copy_ms:.4f} ({n_copies} operations; the "
            f"ring's copies carry {(P - 1) * x.shape[0] * d * 4} B) plain_ms="
            f"{plain_ms:.4f} library_ms={lib_ms:.4f} (several calls: "
            f"torch.bmm and index_add_ per hop) bound_ms={bound:.6f} ({by}: "
            f"{work[0]} B, {work[2]} f32 FLOP or {work[3]} TF32 FLOP) "
            f"pr5_bound_ms={old:.6f}")
    del outs, cases, general_ref
    log(f"kernel.ring sum of 7 at B={TRAIN_BATCH} P={RING_TEMPLATE_PARTS}: "
        f"kernel_ms={acc['ms']:.4f} device_ms={acc['device_ms']:.4f} "
        f"plain_ms={acc['plain_ms']:.4f} library_ms={acc['library_ms']:.4f} "
        f"(several calls) bound_ms={acc['bound_ms']:.6f}")
    return launches, finish_acc(acc)


def recheck_halo_step(state, cfg, stores, device, loss_fn, label):
    """One batch per structure from the trained state through the halo
    loss and through ``dense_batch_loss``: the same loss and gradients
    (<= TOL_ORACLE relative; f32 both, other sum orders)."""
    from mpqe_tpu_torch.data.store import pack_dense_batch_np
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    model = state.model
    params = dict(model.named_parameters())
    for structure, f_stores in stores.items():
        fstore = max(f_stores, key=lambda f: f.n_queries)
        batch = pack_dense_batch_np(
            fstore, np.arange(min(fstore.n_queries, TRAIN_BATCH)),
            TRAIN_BATCH, 4, 11)
        t = loop_mod.batch_tensors(batch, device)
        loss_h = loss_fn(model, cfg, structure, *t)
        g_h = torch.autograd.grad(loss_h, list(params.values()),
                                  allow_unused=True)
        loss_d = mpqe_mod.dense_batch_loss(model, cfg, structure, *t)
        g_d = torch.autograd.grad(loss_d, list(params.values()),
                                  allow_unused=True)
        lh, ld = float(loss_h.detach()), float(loss_d.detach())
        e_loss = abs(lh - ld) / max(abs(ld), 1e-12)
        e_grad = tree_rel_err(dict(zip(params, g_h)), dict(zip(params, g_d)))
        line = (f"{label}.recheck {structure:14s} loss={lh:.6f} "
                f"loss_err_vs_dense={e_loss:.3e} "
                f"grad_err_vs_dense={e_grad:.3e}")
        log(line)
        if e_loss > TOL_ORACLE or e_grad > TOL_ORACLE or not np.isfinite(lh):
            raise AssertionError(line)


def phase_halo_train(kg, train_q, device):
    """``run_train`` on the card through ``make_halo_train_step``'s loss
    (``rgcn_ring_halo`` and ``rgcn_dst_partitioned``) on HALO_PARTS parts
    of one card, HALO_STEPS steps each: finite losses, step p50/p95 and
    real queries/s, one recheck per structure against the dense loss and
    a profile of PROFILE_STEPS steps."""
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.parallel import halo_train as ht
    from mpqe_tpu_torch.parallel.mesh import make_mesh
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    mesh = make_mesh((HALO_PARTS, 1), devices=[device] * HALO_PARTS)
    stores = build_stores(train_q, kg=kg)
    for kind in ("ring", "gather"):
        label = f"halo.train.{kind}"
        tc = loop_mod.TrainConfig(lr=0.01, batch_size=TRAIN_BATCH, n_neg=4,
                                  max_steps=HALO_STEPS, val_every=1 << 30,
                                  burn_in_structure="none", seed=0)
        gen = torch.Generator(device=device).manual_seed(3)
        state = ht.init_halo_train_state(gen, cfg, tc, mesh)
        step = ht.make_halo_train_step(cfg, state.optimizer, mesh,
                                       layer_kind=kind)
        real = []  # per step, the batch's real rows

        def counted(*a):
            real.append(a[-1].sum())
            return step(*a)

        records = []
        t0 = time.perf_counter()
        loop_mod.run_train(state, cfg, tc, train_q, log_fn=records.append,
                           train_step=counted, kg=kg, train_stores=stores)
        wall = time.perf_counter() - t0
        steps = [r for r in records if "loss" in r]
        losses = [r["loss"] for r in steps]
        ms = np.asarray([r["seconds"] * 1e3 for r in steps])
        if len(losses) != HALO_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"{label}: {len(losses)} steps, finite: "
                                 f"{all(np.isfinite(losses))}")
        n_real = int(torch.stack(real).sum())
        log(f"{label}: {state.step} steps in {wall:.2f} s on "
            f"{HALO_PARTS} parts of {torch.cuda.get_device_name(device)}: "
            f"loss first={losses[0]:.6f} last={losses[-1]:.6f} "
            f"step_ms_p50={np.percentile(ms, 50):.3f} "
            f"step_ms_p95={np.percentile(ms, 95):.3f} "
            f"train_queries_per_s={n_real / ms.sum() * 1e3:.1f} "
            f"({n_real} real rows of {len(ms) * TRAIN_BATCH}) "
            f"padded_rows_per_s={len(ms) * TRAIN_BATCH / ms.sum() * 1e3:.1f}")
        recheck_halo_step(state, cfg, stores, device,
                          ht.halo_batch_loss_fn(mesh, layer_kind=kind), label)
        ptc = dataclasses.replace(tc, max_steps=PROFILE_STEPS)
        profile_device(f"{label}.profile ({PROFILE_STEPS} steps)",
                       lambda: loop_mod.run_train(
                           state, cfg, ptc, train_q, train_step=step, kg=kg,
                           train_stores=stores))
        del state, step
        torch.cuda.empty_cache()


def build_kernels() -> None:
    """Build the seven kernel libraries at once (one nvcc each, in
    parallel) and print what ptxas reports of registers and spills."""
    import threading

    from mpqe_tpu_torch.ops import cuda_build
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.ops import rgcn_blocked as rb
    from mpqe_tpu_torch.ops import rgcn_fused as rf
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.ops import sddmm as sd
    from mpqe_tpu_torch.ops import segment_kernels as sk

    errors = []

    def build(fn):
        try:
            fn()
        except BaseException as e:  # re-raised below, in this thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(fn,))
               for fn in (ff._kernel, ff._tgt_kernel, rf._kernel, rb._kernel,
                          sk._kernel, sd._kernel, ring._kernel)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    names = ("fused_multi", "fused_tgt", "rgcn_fused", "rgcn_blocked",
             "segment", "sddmm", "ring")
    log(f"build: {' + '.join(names)} {time.perf_counter() - t0:.2f} s")
    for name in names:
        for ln in cuda_build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"build: {name}: {ln.strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")

    from mpqe_tpu_torch.data.sampler import make_random_kg
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd as ff

    device = torch.device("cuda")
    t_start = time.perf_counter()
    build_kernels()

    cfg = mpqe_mod.MPQEConfig(**FLAGSHIP)
    gen = torch.Generator(device=device).manual_seed(0)
    model = mpqe_mod.init_mpqe(gen, cfg, device=device)
    with torch.no_grad():  # non-zero biases, so the kernel's bias path counts
        for lp in model.layers:
            lp.bias.normal_(0.0, 0.1, generator=gen)
    ops = ff.prepare_fused_multi(model, cfg)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)

    fields = phase_kernel(model, cfg, ops, device, gen, flush)
    tgt_fields = phase_fused_tgt(model, cfg, device, gen, flush)
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops

    full_layer = rgcn_ops.init_rgcn_layer(gen, cfg.embed_dim, cfg.embed_dim,
                                          cfg.n_rels, None, device=device)
    k5_fields = phase_rgcn_fused(model.layers[0], full_layer, cfg, device,
                                 gen, flush)
    k6_fields = phase_rgcn_blocked(model.layers[0], cfg, device, gen, flush)
    del full_layer
    k4_fields = phase_segment(cfg, device, flush)
    k7_launches, k7_fields = phase_sddmm(model, cfg, device, flush)
    k8_launches, k8_fields = phase_ring(model.layers[0], cfg, device, gen,
                                        flush)

    t0 = time.perf_counter()
    kg = make_random_kg(**KG)
    log(f"setup: make_random_kg {time.perf_counter() - t0:.2f} s "
        f"({kg.n_entities} entities, {kg.n_triples} triples)")
    if (kg.n_entities, kg.n_modes, kg.n_rels) != (
            cfg.n_entities, cfg.n_modes, cfg.n_rels):
        raise AssertionError("KG does not match the flagship model")
    launches = phase_serve(model, cfg, ops, kg, device)
    del ops
    train_q, val_q = sample_train_queries(kg)
    k4_launches = phase_eval_sparse(model, cfg, kg, train_q, val_q, device)
    phase_eval_ranking(model, cfg, kg, val_q, device)
    del model
    k1, k2 = phase_train(kg, train_q, val_q, device)
    sparse = {}
    for label in SPARSE_RUNS:
        for kid, n in phase_train_sparse(kg, train_q, device, label).items():
            sparse[kid] = sparse.get(kid, 0) + n
    phase_halo_train(kg, train_q, device)
    phase_train_cli(["--kernel", "fused_fwd", "--fused_backward", "pallas"],
                    then=lambda d: (phase_eval_cli(d), phase_serve_cli(d)))
    phase_train_cli(["--kernel", "blocked"])
    # K6's wide paths on the train path (16 bases, as every CLI run here)
    phase_train_cli(["--kernel", "blocked", "--embed_dim", "256"])
    phase_train_cli(["--parallel", "halo_ring"])
    log(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "fused_tgt_forward_multi",
        "route": "cuda",
        "source": "mpqe_tpu_torch/csrc/fused_multi.cu",
        "replaces": "mpqe_tpu/ops/pallas_fused_fwd.py:335",
        "launches": launches,
        **fields,
    }]
    for name, line, n, kind in (
            ("tgt_mma_forward", 704, k1, "fwd"),
            ("tgt_mma_backward", 569, k2, "bwd")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpqe_tpu_torch/csrc/fused_tgt.cu",
            "replaces": f"mpqe_tpu/ops/pallas_fused_fwd.py:{line}",
            "launches": n,
            **tgt_fields[kind],
        })
    for kid, name, source, line, fl in (
            ("K5a", "rgcn_messages_basis", "rgcn_fused.cu",
             "pallas_rgcn.py:145", k5_fields),
            ("K5b", "rgcn_messages_wrel", "rgcn_fused.cu",
             "pallas_rgcn.py:193", k5_fields),
            ("K6a", "rgcn_messages_blocked", "rgcn_blocked.cu",
             "pallas_rgcn_blocked.py:253", k6_fields),
            ("K6b", "rgcn_grad_blocked", "rgcn_blocked.cu",
             "pallas_rgcn_blocked.py:384", k6_fields)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"mpqe_tpu_torch/csrc/{source}",
            "replaces": f"mpqe_tpu/ops/{line}",
            "launches": sparse[kid],
            **fl[kid],
        })
    for kid, name, source, line, n, fl in (
            ("K4a", "segment_sum", "segment.cu", "pallas_segment.py:56",
             k4_launches["K4a"], k4_fields["K4a"]),
            ("K4b", "segment_max", "segment.cu", "pallas_segment.py:120",
             k4_launches["K4b"], k4_fields["K4b"]),
            # the first half of K4a's and K4b's port: the TPU kernels need
            # no layout (a one-hot matmul per chunk of rows)
            ("K4L", "segment_layout", "segment.cu", "pallas_segment.py:56",
             k4_launches["layout"], k4_fields["layout"]),
            ("K7", "sddmm", "sddmm.cu", "pallas_sddmm.py:48", k7_launches,
             k7_fields),
            ("K8", "rgcn_ring_halo", "ring.cu", "pallas_ring.py:159",
             k8_launches, dict(k8_fields, library_calls=(
                 "several: torch.bmm and index_add_ per hop")))):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"mpqe_tpu_torch/csrc/{source}",
            "replaces": f"mpqe_tpu/ops/{line}",
            "launches": n,
            **fl,
        })
    log(f"kernels: {[k['name'] for k in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
