"""The port's profiling window against the JAX package on the CPU:
``utils/profiling.py``'s ``trace`` and ``StepTimer``, and the train CLI's
``--trace`` window, whose ``trace_start`` / ``trace_done`` steps must
equal the root ``train.py --trace``'s on the same arguments (the
reference writes a ``jax.profiler`` TensorBoard profile, the port a
``torch.profiler`` Chrome trace)."""

import json
import os

import numpy as np
import pytest
import torch

from mpqe_tpu.utils import profiling as jprof
from mpqe_tpu_torch.utils import profiling as tprof

ARGS = ["--data", "synthetic", "--embed_dim", "16", "--n_layers", "1",
        "--readout", "sum", "--steps", "40", "--val_every", "100",
        "--batch_size", "32", "--n_neg", "2", "--structures", "1-chain",
        "--syn_entities", "120", "--syn_triples", "300",
        "--syn_train_queries", "100", "--syn_val_queries", "20",
        "--trace", "5", "--trace_skip", "10"]


def _trace_files(d):
    return [os.path.join(dp, f) for dp, _, fs in os.walk(d) for f in fs]


def test_step_timer_summary_matches_jax():
    samples = [0.5, 0.1, 0.3, 0.25, 0.9, 0.05]
    jt, tt = jprof.StepTimer(), tprof.StepTimer()
    assert tt.summary() == jt.summary() == {}
    for s in samples:
        jt.samples.append(s)
        tt.samples.append(s)
    assert tt.summary() == jt.summary()
    with tt.measure():
        pass
    assert len(tt.samples) == len(samples) + 1 and tt.samples[-1] >= 0.0
    assert set(tt.summary()) == {"steps", "mean_s", "p50_s", "p95_s"}


def test_trace_writes_a_chrome_trace_and_stops_on_an_exception(tmp_path):
    d = str(tmp_path / "t")
    with tprof.trace(d) as got:
        torch.ones(8).sum()
    assert got == d
    files = _trace_files(d)
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sum" in str(e.get("name")) for e in events)
    with pytest.raises(ValueError, match="inside"):
        with tprof.trace(d):
            torch.ones(8).sum()
            raise ValueError("inside the window")
    assert len(_trace_files(d)) == 2
    # the profiler was stopped: a new window starts
    with tprof.trace(d):
        pass
    assert len(_trace_files(d)) == 3


def _events(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    return [(r["event"], r["step"]) for r in recs
            if r.get("event") in ("trace_start", "trace_done")], recs


@pytest.mark.parametrize("k", ["1", "4"])
def test_cli_trace_window_steps_equal_train_py(k, tmp_path):
    import train as jtrain
    from mpqe_tpu_torch.train.__main__ import main

    args = ARGS + ["--steps_per_call", k]
    jrun, trun = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrain.main(args + ["--run_dir", jrun])
    main(args + ["--device", "cpu", "--run_dir", trun])
    want, _ = _events(jrun)
    got, recs = _events(trun)
    assert got == want and len(got) == 2
    # K steps a call: the window opens at the first call boundary at or
    # past step 10 and closes at the first at or past 15 (its requested
    # start + 5), as the reference's: 12..16 at K = 4
    assert got == ([("trace_start", 10), ("trace_done", 15)] if k == "1"
                   else [("trace_start", 12), ("trace_done", 16)])
    done = next(r for r in recs if r.get("event") == "trace_done")
    assert done["trace_dir"] == os.path.join(trun, "trace")
    assert done["window"]["steps"] == got[1][1] - got[0][1]
    assert np.isfinite(done["window"]["p50_s"])
    assert len(_trace_files(os.path.join(trun, "trace"))) == 1


def test_trace_window_closes_when_a_step_raises(tmp_path):
    """A step that raises inside the window leaves no live profiler: the
    trace is written and the next window opens."""
    from mpqe_tpu_torch.train import __main__ as tcli
    from mpqe_tpu_torch.train import loop as tloop

    real = tloop.run_step
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("step failed")
        return real(*a, **kw)

    run = str(tmp_path / "r")
    tloop.run_step = failing
    try:
        with pytest.raises(RuntimeError, match="step failed"):
            tcli.main(ARGS[:-4] + ["--trace", "5", "--trace_skip", "2",
                                   "--device", "cpu", "--run_dir", run])
    finally:
        tloop.run_step = real
    assert len(_trace_files(os.path.join(run, "trace"))) == 1
    assert not torch._C._autograd._profiler_enabled()
    with tprof.trace(str(tmp_path / "again")):
        pass
