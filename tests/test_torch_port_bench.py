"""The port's benchmark driver (``python -m mpqe_tpu_torch.bench``) and
its profiling module (``mpqe_tpu_torch/utils/profiling.py``) on the CPU:
the executed edge-message count against the JAX package's, the K1
roofline's bytes and FLOP against a hand recount, the dense roofline's
work against the reference's ``"xla"`` rules, ``loop_time``'s rule, and
one whole run of ``bench.main`` under ``--device cpu`` with its constants
shrunk (as the reference's ``_guard_relay`` shrinks them), its JSON line
checked key by key and by ``chip_smoke.check_bench_record``.
"""

import json
import math
import sys
import time
from pathlib import Path

import jax  # noqa: F401  (the JAX package's modules below need it loaded)
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.queries import STRUCTURE_NAMES
from mpqe_tpu.utils import profiling as jprof
from mpqe_tpu_torch import bench
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.utils import profiling as tprof

REFERENCE_EXTRA_KEYS = (
    "backend", "fwd_seconds", "fwd_seconds_xla", "fwd_impl",
    "fwd_edges_per_s", "train_step_seconds", "train_queries_per_s", "batch",
    "edge_msgs_per_fwd", "logical_edge_msgs_per_fwd", "roofline_fraction",
    "roofline_bound", "roofline_min_ms", "roofline_impl", "roofline_model",
    "roofline_note", "pinned_torch_fwd_edges_per_s",
    "vs_baseline_denominator", "torch_fwd_seconds", "torch_fwd_edges_per_s",
    "torch_batch", "torch_train_step_seconds", "torch_train_queries_per_s",
    "vs_baseline_fresh", "best_stack", "configs", "shared_neg_variant",
    "kernel_paths")


def _cfgs(readout, n_layers, **kw):
    args = dict(n_entities=50, n_modes=4, n_rels=9, embed_dim=16,
                n_layers=n_layers, num_bases=4, readout=readout)
    args.update(kw)
    return jm.MPQEConfig(**args), tm.MPQEConfig(**args)


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("readout", ["tgt", "sum", "max"])
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_executed_edge_messages_match_jax(structure, readout, n_layers):
    jcfg, tcfg = _cfgs(readout, n_layers)
    want = jm.executed_edge_messages(jcfg, structure)
    assert tm.executed_edge_messages(tcfg, structure) == want
    if readout == "tgt" and structure == "3-chain_inter" and n_layers == 3:
        assert want == 4  # the bench's 4 of the logical 6


# Hand recount at the flagship width of the function K1 computes (see
# profiling.chain_work): the plans are
#   3-chain_inter: layer 0 in (0, 1, 2, 3) -> (2, 3), edges 0->2, 1->2,
#     2->3; layer 1 in (2, 3) -> (3,), edge 2->3.  Anchors 0, 1; the
#     variable slots 2, 3.  Pairs of layer 0: (2,2), (3,3), (2,3) from a
#     variable (3 selected rows), (0,2), (1,2) blocks; layer 1: (3,3),
#     (2,3) blocks.  4 blocks, 3 variable rows, 3 output slots (2 in
#     layer 0).
#   2-inter: one layer, in (0, 1, 2) -> (2,), edges 0->2, 1->2; variable
#     slot 2: (2,2) one selected row, (0,2), (1,2) blocks.  2 blocks, 1
#     variable row, 1 output slot.
HAND = {"3-chain_inter": dict(anchors=2, n_var=2, blocks=4, var_rows=3,
                              outs=3, outs0=2),
        "2-inter": dict(anchors=2, n_var=1, blocks=2, var_rows=1, outs=1,
                        outs0=1)}


@pytest.mark.parametrize("variant", ["base", "out_bf16", "fold_bias"])
@pytest.mark.parametrize("structure", list(HAND))
def test_k1_roofline_matches_hand_count(structure, variant):
    B, d, m = 131_072, 128, 4
    h = HAND[structure]
    cfg = tm.MPQEConfig(n_entities=1_000_000, n_modes=m, n_rels=266,
                        embed_dim=d, n_layers=3, num_bases=16)
    params = h["blocks"] * d * d + h["var_rows"] * m * d
    bias = h["outs"] * d * 4
    if variant == "fold_bias":  # layer 0's bias as bf16 rows of W_0
        params += h["outs0"] * d
        bias -= h["outs0"] * d * 4
    out = B * d * (2 if variant == "out_bf16" else 4)
    nbytes = (B * h["anchors"] * d * 2 + B * h["n_var"] * 4 + params * 2
              + bias + out)
    mma = 2 * B * d * d * h["blocks"]
    f32 = B * d * (h["outs"] + h["var_rows"])
    kw = {variant: True} if variant != "base" else {}
    assert tprof.chain_work(cfg, structure, B, False, **kw) == (nbytes, mma,
                                                                f32)
    rl = tprof.mpqe_fwd_roofline(B, cfg, structure, impl="k1", **kw)
    assert rl.hbm_bytes == nbytes and rl.flops == mma + f32
    assert rl.memory_s == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert rl.compute_s == pytest.approx(max(mma / 989e12, f32 / 67e12),
                                         rel=1e-12)
    assert rl.min_seconds == max(rl.memory_s, rl.compute_s)
    assert rl.bound == ("memory" if rl.memory_s > rl.compute_s
                        else "compute")


@pytest.mark.parametrize("readout", ["tgt", "sum"])
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_dense_roofline_counts_the_reference_xla_work(structure, readout):
    """The dense route's work is the reference's ``impl="xla"`` count (its
    TPU peaks are not carried: the times are the H100's)."""
    jcfg, tcfg = _cfgs(readout, 3, n_entities=1_000_000)
    want = jprof.mpqe_fwd_roofline(4096, jcfg, structure, impl="xla")
    got = tprof.mpqe_fwd_roofline(4096, tcfg, structure, impl="dense")
    assert got.flops == want.flops and got.hbm_bytes == want.hbm_bytes
    assert got.compute_s == pytest.approx(want.flops / 67e12, rel=1e-12)
    assert got.memory_s == pytest.approx(want.hbm_bytes / 3.35e12,
                                         rel=1e-12)
    with pytest.raises(ValueError):
        tprof.mpqe_fwd_roofline(4096, tcfg, structure, impl="xla")


def test_loop_time_overhead_cancelled_median():
    calls = []

    def step(n):  # a fixed 20 ms plus 10 ms an iteration
        calls.append(n)
        time.sleep(0.02 + 0.01 * n)
        return torch.zeros(())

    dt = tprof.loop_time(step, n_small=1, n_large=6, samples=3, device="cpu")
    assert calls[0] == 2 and calls[1:] == [1, 6] * 3  # warm-up, 3 pairs
    # sleeps overshoot by scheduling delays: the fixed part cancels, the
    # rest moves the per-iteration figure by a few of them over 5
    assert 0.008 < dt < 0.015, dt


def test_loop_time_refuses_when_every_delta_is_non_positive():
    calls = []

    def step(n):  # the small loop stalls: every delta is negative
        calls.append(n)
        time.sleep(0.03 if n == 1 else 0.0)
        return torch.zeros(())

    with pytest.raises(tprof.TimingError):
        tprof.loop_time(step, n_small=1, n_large=3, samples=2, device="cpu")
    assert calls == [2] + [1, 3] * 4  # warm-up, then samples + 2 pairs


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.fixture
def tiny_bench(monkeypatch):
    """``bench``'s module constants shrunk for a CPU run of seconds."""
    for name, value in dict(
            D=16, N_ENTITIES=2_000, NUM_BASES=4, BATCH=64, TORCH_BATCH=64,
            TORCH_ITERS=1, TORCH_ENTITIES=2_000, N_SMALL=1, N_LARGE=2,
            N_LARGE_FWD=2, SAMPLES=1, MATRIX_SMALL_ITERS=(1, 2),
            BEST_STACK_ITERS=(1, 2)).items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setattr(bench, "MATRIX_CONFIGS", [
        dict(mc, n_entities=min(mc["n_entities"], 500),
             batch=min(mc["batch"], 32)) for mc in bench.MATRIX_CONFIGS])
    monkeypatch.setattr(bench, "BROKEN_TIMINGS", [])
    monkeypatch.setenv("MPQE_BENCH_MATRIX", "1")
    monkeypatch.setenv("MPQE_BENCH_KERNELS", "1")
    return bench


def test_bench_main_on_the_cpu_prints_one_json_line(tiny_bench, capsys):
    assert tiny_bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert rec["metric"] == "rgcn_fwd_edges_per_s_chip"
    assert rec["unit"] == "edge_messages/s"
    ex = rec["extra"]
    missing = [k for k in REFERENCE_EXTRA_KEYS if k not in ex]
    assert not missing, missing
    assert ex["edge_msgs_per_fwd"] == 64 * 4
    assert ex["logical_edge_msgs_per_fwd"] == 64 * 2 * 3
    assert ex["backend"] == "cpu" and ex["device"]["platform"] == "cpu"
    assert ex["fwd_impl"] in ("plain_k1", "plain_k1_obf16")
    assert ex["roofline_impl"] == ex["fwd_impl"][len("plain_"):]
    assert ex["roofline_fraction"] is None  # no H100 share from a CPU run
    assert ex["roofline_model"] == tprof.ROOFLINE_MODEL
    assert ex["vs_baseline_fresh"] == rec["vs_baseline"]
    assert ex["pinned_torch_fwd_edges_per_s"] is None
    for v in (rec["value"], rec["vs_baseline"], ex["fwd_seconds"],
              ex["fwd_seconds_xla"], ex["fwd_seconds_k1"],
              ex["fwd_seconds_k1_obf16"], ex["fwd_seconds_k1_fold_bias"],
              ex["train_step_seconds"],
              ex["train_queries_per_s"], ex["roofline_min_ms"],
              ex["torch_fwd_edges_per_s"], ex["torch_train_step_seconds"]):
        assert isinstance(v, float) and math.isfinite(v) and v > 0, v
    assert ex["fwd_seconds"] == min(ex["fwd_seconds_k1"],
                                    ex["fwd_seconds_k1_obf16"])
    # no profile on the CPU: K1's device ms and the busy share are the
    # card's
    assert ex["fwd_k1_kernel_ms"] is None
    assert ex["fwd_device_busy_share"] is None and ex["fwd_profile"] is None
    assert [r["name"] for r in ex["configs"]] == [
        mc["name"] for mc in bench.MATRIX_CONFIGS]
    for row in ex["configs"]:
        for k in ("fwd_ms", "fwd_edges_per_s", "train_step_ms",
                  "train_queries_per_s"):
            assert math.isfinite(row[k]) and row[k] > 0, (row, k)
        assert row["roofline_fraction"] is None
    assert [r["kernel"] for r in ex["kernel_paths"]] == [
        "dense", "fused", "blocked", "fused_fwd"]
    for row in ex["kernel_paths"]:
        assert "error" not in row, row
        assert math.isfinite(row["train_step_ms"]) and row["batch"] == 64
    assert ex["kernel_paths"][2]["queries_per_block"] == 128
    # the two shared-negatives variants: their step times, labelled
    assert ex["best_stack"]["config"] == (
        "dtype=bfloat16 shared_negatives=512 kernel=fused_fwd "
        "fused_backward=pallas")
    assert "VARIANT" in ex["best_stack"]["protocol_note"]
    assert ex["shared_neg_variant"]["n_shared_negatives"] == 512
    assert ex["shared_neg_variant"]["protocol"] == "shared_negatives_variant"
    for row in (ex["best_stack"], ex["shared_neg_variant"]):
        for k in ("train_step_ms", "train_queries_per_s"):
            assert isinstance(row[k], float) and math.isfinite(row[k]) \
                and row[k] > 0, (row, k)
    assert "broken_timings" not in ex
    # the chip check's rule: this line fails it only where a CPU run
    # differs from the card's (the route, the roofline share, the
    # profile's figures)
    bad = _chip_smoke().check_bench_record(rec, batch=64)
    assert len(bad) == 4 and "fwd_impl" in bad[0] and \
        "roofline_fraction" in bad[1] and "fwd_k1_kernel_ms" in bad[2] \
        and "fwd_device_busy_share" in bad[3], bad
    card = json.loads(lines[0])
    card["extra"].update(fwd_impl="cuda_k1", roofline_fraction=0.5,
                         fwd_k1_kernel_ms=0.2, fwd_device_busy_share=0.25)
    assert _chip_smoke().check_bench_record(card, batch=64) == []
    for edit in (dict(roofline_fraction=1.2), dict(broken_timings=["x"]),
                 dict(edge_msgs_per_fwd=64 * 6), dict(fwd_seconds_k1=None),
                 dict(fwd_impl="torch_dense"),
                 dict(fwd_seconds_k1_fold_bias=float("nan")),
                 dict(fwd_device_busy_share=1.5),
                 dict(best_stack="not measured"),
                 dict(shared_neg_variant={"train_step_ms": 0.0})):
        worse = json.loads(json.dumps(card))
        worse["extra"].update(edit)
        assert _chip_smoke().check_bench_record(worse, batch=64), edit
    worse = json.loads(json.dumps(card))
    worse["extra"]["kernel_paths"][1] = {"kernel": "fused", "error": "boom"}
    assert _chip_smoke().check_bench_record(worse, batch=64)


@pytest.mark.parametrize("broken", [(1, 2), (1,)],
                         ids=["both_k1_routes", "base_k1_only"])
def test_bench_broken_k1_timing(tiny_bench, monkeypatch, capsys, broken):
    """A K1 forward loop whose deltas are all non-positive: with both K1
    routes broken the driver raises ``TimingError`` and prints no line
    (no other route stands in for the K1 headline); with one broken the
    other K1 route is the headline and the failure is recorded.  Calls of
    ``loop_time``: 0 ``encode_dense``, 1 K1, 2 K1 ``out_bf16``."""
    real, calls = tprof.loop_time, []

    def loop_time(loop_fn, **kw):
        calls.append(len(calls))
        if calls[-1] in broken:
            raise tprof.TimingError("every delta <= 0 (forced)")
        return real(loop_fn, **kw)

    monkeypatch.setattr(tprof, "loop_time", loop_time)
    monkeypatch.delenv("MPQE_BENCH_MATRIX")
    monkeypatch.delenv("MPQE_BENCH_KERNELS")
    if len(broken) == 2:
        with pytest.raises(tprof.TimingError, match="neither K1"):
            tiny_bench.main(["--device", "cpu"])
        assert capsys.readouterr().out == ""
        assert len(calls) == 3  # stopped before fold_bias and the step
        return
    assert tiny_bench.main(["--device", "cpu"]) == 0
    ex = json.loads(capsys.readouterr().out)["extra"]
    assert ex["fwd_impl"] == "plain_k1_obf16"
    assert math.isnan(ex["fwd_seconds_k1"])
    assert ex["fwd_seconds"] == ex["fwd_seconds_k1_obf16"] > 0
    assert len(ex["broken_timings"]) == 1
    assert _chip_smoke().check_bench_record(
        {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 1.0,
         "extra": ex}, batch=64)


def test_bench_without_a_card_raises(tiny_bench):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiny_bench.main([])
