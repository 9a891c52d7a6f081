"""Timing and rooflines on the card (counterpart of
``mpqe_tpu/utils/profiling.py``).

* :func:`loop_time`: the reference's overhead-cancelled seconds per
  iteration, ``(t(n_large) - t(n_small)) / (n_large - n_small)``, the
  median of the positive deltas, timed with CUDA events on the card and
  ``time.perf_counter`` on the CPU.
* The H100's published peaks, :func:`bound_times` (the least time the card
  could take for a count of bytes and operations) and :func:`chain_work`
  (K1's and K2's count), which ``chip_smoke.py`` and ``bench.py`` share.
* :func:`mpqe_fwd_roofline`: the speed of light of one MPQE forward on
  the H100, for the route that ``python -m mpqe_tpu_torch.bench`` timed.
* :func:`device_profile`: device time by kernel over one call
  (``torch.profiler``) beside its wall time.
* :func:`trace` (and :func:`start_trace` / :func:`stop_trace` for a
  window that spans loop iterations, as the train CLI's ``--trace``): a
  ``torch.profiler`` window written as a Chrome trace (the reference's
  ``jax.profiler`` trace is a TensorBoard profile);
  :class:`StepTimer`: wall-clock step percentiles.

The reference's TPU peaks are not carried across.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W power limit
H100_BF16_FLOPS = 989e12  # bf16 tensor cores
H100_TF32_FLOPS = 495e12  # TF32 tensor cores
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3

# Host idle seconds at each end of a profiled window.  Without it a short
# window on the H100 sometimes records none of its device events (3 of
# 200 five-kernel windows; none of 400 with 5 or 50 ms:
# ``python -m mpqe_tpu_torch.tools.profile_probe``).
PROFILE_PAD_S = 0.02
# Launches of a marker kernel in the warmup step that :func:`start_trace`
# records and drops before its window: late in a long process a profile
# without a warmup step lost its first launches (``chip_smoke.py``'s
# ``device_ms``), and a padded train window its first step's forward.
TRACE_WARMUP_LAUNCHES = 64

# The roofline model of :func:`mpqe_fwd_roofline`: the function's own
# work on the H100's peaks.  Its fractions are not comparable with the
# reference's "compulsory-traffic-v2" (TPU v5e peaks, padded-block FLOP).
ROOFLINE_MODEL = "h100-function-work-v1"


def _traces_cuda() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def start_trace(log_dir: str) -> "torch.profiler.profile":
    """Start a ``torch.profiler`` window that records CPU activity, and
    CUDA activity when this process has initialised the card; stop it
    with :func:`stop_trace`.  On the card a warmup step comes first
    (``TRACE_WARMUP_LAUNCHES`` marker launches, as :func:`device_profile`
    and ``chip_smoke.py``'s profiles take a warmup step), whose events
    the profiler drops; the window then starts with the device idle and
    ``PROFILE_PAD_S`` of host idle time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    cuda = _traces_cuda()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    if cuda:
        marker = torch.empty(1, device="cuda")
        for _ in range(TRACE_WARMUP_LAUNCHES):
            marker.fill_(1.0)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    prof.step()
    if cuda:
        time.sleep(PROFILE_PAD_S)
    return prof


def stop_trace(prof, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace under ``log_dir``
    (``trace_<pid>_<ns>.json``, viewable in Perfetto or
    ``chrome://tracing``); returns the file's path.  On the card the
    window ends with the device idle and ``PROFILE_PAD_S`` of host idle
    time.  The profiler stops even if the device reports an error."""
    try:
        if _traces_cuda():
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
    finally:
        prof.stop()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """A profiler window around the ``with`` body (:func:`start_trace`);
    it stops and writes its trace even when the body raises."""
    prof = start_trace(log_dir)
    try:
        yield log_dir
    finally:
        stop_trace(prof, log_dir)


class StepTimer:
    """Wall-clock step timer with percentile summaries for the training
    loop's JSONL metrics."""

    def __init__(self):
        self.samples: list = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {
            "steps": len(a),
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p95_s": float(np.percentile(a, 95)),
        }


class TimingError(RuntimeError):
    """Every overhead-cancelled delta of :func:`loop_time` was <= 0."""


def loop_time(
    step_fn: Callable,
    n_small: int = 5,
    n_large: int = 55,
    samples: int = 3,
    log: Callable[[str], None] = lambda m: None,
    device="cuda",
) -> float:
    """Overhead-cancelled seconds per iteration of ``step_fn(n)``, which
    runs its work n times with a data dependency threaded through the
    iterations and returns a scalar tensor.

    After one warm-up call (``step_fn(2)``), up to ``samples + 2`` pairs
    ``t(n_small)``, ``t(n_large)`` give deltas ``(t_large - t_small) /
    (n_large - n_small)``; the positive ones are kept, and their median
    is returned once ``samples`` of them are in.  If every delta is <= 0
    it raises :class:`TimingError`: a broken measurement fails instead of
    recording a garbage time.  On a CUDA ``device`` each ``t(n)`` is the
    time between CUDA events recorded around ``step_fn(n)`` on the
    current stream, after synchronising on the end event (a host that
    cannot keep the card busy shows in it); on the CPU it is
    ``time.perf_counter`` around ``float(step_fn(n))``."""
    dev = torch.device(device)

    if dev.type == "cuda":
        def timed(n):
            with torch.cuda.device(dev):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                step_fn(n)
                b.record()
                b.synchronize()
                return a.elapsed_time(b) / 1e3
    else:
        def timed(n):
            t0 = time.perf_counter()
            float(step_fn(n))
            return time.perf_counter() - t0

    float(step_fn(2))  # warm-up: kernel builds, allocator pools
    deltas = []
    for _ in range(samples + 2):
        t_small = timed(n_small)
        t_large = timed(n_large)
        dt = (t_large - t_small) / (n_large - n_small)
        if dt > 0:
            deltas.append(dt)
        else:
            log(f"  timing retry: t({n_small})={t_small:.4f}s >= "
                f"t({n_large})={t_large:.4f}s")
        if len(deltas) >= samples:
            break
    if not deltas:
        raise TimingError(
            "loop_time: every overhead-cancelled delta was non-positive; "
            "refusing to report a garbage time")
    deltas.sort()
    log(f"  samples(ms): {['%.3f' % (d * 1e3) for d in deltas]}")
    return deltas[len(deltas) // 2]


def device_profile(fn) -> tuple:
    """``(wall_us, rows)`` of one ``fn()`` on the card under
    ``torch.profiler``: the host's wall time from a synchronised start to
    a synchronised end, and per kernel ``(device us, launches, name)``,
    largest first.  Device work only: a user annotation's range
    (``Optimizer.step``) spans kernels that are counted on their own.
    A warmup step of ``TRACE_WARMUP_LAUNCHES`` marker launches comes
    first and is dropped, as in :func:`start_trace` (late in a long
    process a window without one recorded no device event at all); the
    recorded window is padded with ``PROFILE_PAD_S`` of host idle time
    at each end, and the wall time leaves the pads out."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    marker = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(TRACE_WARMUP_LAUNCHES):
            marker.fill_(1.0)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_PAD_S)
        prof.step()
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    return wall_us, rows


def bound_times(work) -> tuple:
    """(ms for the bytes, ms for the operations) on the card's peaks; the
    bf16 tensor-core and f32 pipes run side by side, so the operations
    take the longer of the two.  ``work`` is (bytes, bf16 FLOP, f32 FLOP);
    a fourth entry (K5) is the TF32 FLOP of another route to the same f32
    products (split TF32 on the tensor cores): the f32 FLOP take the
    faster of the two routes."""
    nbytes, mma, f32 = work[:3]
    t_f32 = f32 / H100_F32_FLOPS
    if len(work) > 3:
        t_f32 = min(t_f32, work[3] / H100_TF32_FLOPS)
    return (nbytes / H100_BYTES_PER_S * 1e3,
            max(mma / H100_BF16_FLOPS, t_f32) * 1e3)


def chain_work(cfg, structure: str, B: int, backward: bool, *,
               out_bf16: bool = False, fold_bias: bool = False) -> tuple:
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
    f32 FLOP are the db sums and the variable rows' dW.

    K1's variants: ``out_bf16`` writes the output in bf16 (2 bytes an
    element); ``fold_bias`` reads layer 0's bias as one bf16 row of W_0
    per output slot instead of an f32 row (the add, one selected row per
    slot, is the B d f32 FLOP it was)."""
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
    f32_bias = outs * d
    if fold_bias and not backward:
        folded = len(plan[0][1]) * d
        params += folded
        f32_bias -= folded
    out_bytes = 2 if out_bf16 and not backward else 4
    nbytes = (B * len(a_slots) * d * 2 + B * len(v_slots) * 4
              + params * 2 + f32_bias * 4 + B * d * out_bytes)
    f32 = B * d * (outs + var_rows)
    if not backward:
        return nbytes, 2 * B * d * d * nnz, f32
    nbytes += B * len(a_slots) * d * 4 + (params + outs * d) * 4
    return nbytes, 2 * B * d * d * (2 * nnz + sum(blocks[:-1])), f32


@dataclasses.dataclass
class RGCNRoofline:
    """Speed of light of one forward: its work and the least time the
    card could take for it."""

    flops: float
    hbm_bytes: float
    compute_s: float
    memory_s: float

    @property
    def bound(self) -> str:
        return "memory" if self.memory_s > self.compute_s else "compute"

    @property
    def min_seconds(self) -> float:
        return max(self.compute_s, self.memory_s)


def mpqe_fwd_roofline(batch: int, cfg, structure: str, impl: str = "dense",
                      *, out_bf16: bool = False,
                      fold_bias: bool = False) -> RGCNRoofline:
    """The least time one MPQE forward of ``batch`` queries of
    ``structure`` could take on the H100, for the route timed:

    * ``impl="k1"``: the function K1 computes (:func:`chain_work`, with
      ``out_bf16`` / ``fold_bias`` as the variant timed): bf16 products
      of the nonzero blocks on the tensor cores, the variable rows'
      selects and the bias adds in f32;
    * ``impl="dense"``: ``encode_dense``'s float32 work by the reference's
      rules for its ``"xla"`` route (``mpqe_tpu/utils/profiling.py:134``):
      per pruned layer every self transform and message a ``[B, d] @ [d,
      d]`` product, the layer-0 terms of variable slots as one-hot
      products over n_modes; bytes: the anchor rows read, the one-hot
      operands, the int32 id and mode reads and the output written, f32.
      On the card these are f32 FLOP (no TF32: the port keeps
      ``allow_tf32`` off), at the f32 peak."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.queries import STRUCTURES

    if impl == "k1":
        work = chain_work(cfg, structure, batch, False, out_bf16=out_bf16,
                          fold_bias=fold_bias)
    elif impl == "dense":
        spec = STRUCTURES[structure]
        steps = mpqe_mod.num_steps(cfg, structure)
        d = cfg.embed_dim
        if cfg.readout == "tgt":
            plan = mpqe_mod._live_slot_plan(spec, steps)
        else:
            all_slots = tuple(range(spec.n_nodes))
            plan = [(all_slots, all_slots, tuple(range(spec.n_edges)))
                    ] * steps
        n_self = sum(len(out) for _, out, _ in plan)
        n_msgs = sum(len(edges) for _, _, edges in plan)
        anchors = set(spec.anchor_slots)
        n_anchor_gathers = len([s for s in plan[0][0] if s in anchors])
        var0 = set(plan[0][0]) - anchors
        l0_in, l0_out, l0_edges = plan[0]
        n_var_terms = (sum(1 for s in l0_out if s in var0)
                       + sum(1 for j in l0_edges
                             if spec.edge_src[j] in var0))
        row = batch * d * 4
        flops = 2.0 * batch * d * d * (n_self + n_msgs - n_var_terms)
        flops += 2.0 * batch * cfg.n_modes * d * n_var_terms
        hbm = n_anchor_gathers * row
        hbm += batch * len(var0) * cfg.n_modes * 4
        hbm += batch * spec.n_nodes * 2 * 4
        hbm += row
        work = (hbm, 0.0, flops)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    t_bytes, t_ops = bound_times(work)
    return RGCNRoofline(flops=float(work[1] + work[2]),
                        hbm_bytes=float(work[0]), compute_s=t_ops / 1e3,
                        memory_s=t_bytes / 1e3)
