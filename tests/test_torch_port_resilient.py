"""The port's crash supervisor (``mpqe_tpu_torch/tools/resilient_train.py``)
in the cases of ``tests/test_resilient.py`` and the SIGTERM case of
``tests/test_preempt.py``, against the port's train CLI on the CPU: a
stand-in that crashes once is relaunched with ``--resume``; a script that
always dies is given up on with its exit code; ``--run_dir`` is required;
a real run SIGKILLed after its first checkpoint resumes from it and
finishes; SIGTERM reaches the child, which checkpoints and exits 0, and
nothing is relaunched."""

import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUP = [sys.executable, "-m", "mpqe_tpu_torch.tools.resilient_train"]
ARGS = ["--device", "cpu", "--data", "synthetic", "--embed_dim", "16",
        "--n_layers", "1", "--readout", "sum", "--batch_size", "32",
        "--n_neg", "2", "--structures", "1-chain", "--syn_entities", "120",
        "--syn_triples", "300", "--syn_train_queries", "100",
        "--syn_val_queries", "20"]

# a train CLI stand-in that crashes hard the first time (after writing
# its "checkpoint") and completes on the relaunch, which must resume
CRASHY = """
import json, os, sys
args = sys.argv[1:]
run_dir = args[args.index("--run_dir") + 1]
os.makedirs(run_dir, exist_ok=True)
marker = os.path.join(run_dir, "crashed_once")
if not os.path.exists(marker):
    open(marker, "w").write("1")
    open(os.path.join(run_dir, "ckpt_step"), "w").write("50")
    sys.exit(17)
assert "--resume" in args, "the supervisor must relaunch with --resume"
step = int(open(os.path.join(run_dir, "ckpt_step")).read())
open(os.path.join(run_dir, "final"), "w").write(
    json.dumps({"resumed_from": step, "final": 100}))
"""


def test_supervisor_relaunches_with_resume(tmp_path):
    script = tmp_path / "crashy_train.py"
    script.write_text(CRASHY)
    run_dir = str(tmp_path / "run")
    rc = subprocess.call(SUP + ["--train_script", str(script), "--backoff",
                                "0.01", "--min_uptime", "0.001", "--",
                                "--run_dir", run_dir], cwd=REPO, timeout=120)
    assert rc == 0
    with open(os.path.join(run_dir, "final")) as f:
        assert json.load(f) == {"resumed_from": 50, "final": 100}


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    script = tmp_path / "always_dies.py"
    script.write_text("import sys; sys.exit(3)\n")
    proc = subprocess.run(
        SUP + ["--train_script", str(script), "--backoff", "0.01",
               "--max_restarts", "2", "--", "--run_dir",
               str(tmp_path / "r")], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 3
    assert proc.stderr.count("[resilient] launching") == 3
    assert "giving up after 2 restarts (last rc=3)" in proc.stderr


def test_supervisor_requires_run_dir():
    proc = subprocess.run(SUP + ["--", "--steps", "10"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--run_dir is required" in proc.stderr


def _records(run_dir):
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.endswith("\n")]


def _child_of(pid):
    """The supervisor's running child (Linux ``/proc``), or None."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            kids = f.read().split()
    except OSError:
        return None
    return int(kids[0]) if kids else None


def test_real_resume_after_kill(tmp_path):
    """The port's train CLI under the supervisor, SIGKILLed once its first
    checkpoint exists: relaunched with --resume, it logs ``resumed`` at
    that checkpoint's step and trains on to the end with exit 0."""
    run_dir = str(tmp_path / "run")
    proc = subprocess.Popen(
        SUP + ["--backoff", "0.01", "--"] + ARGS
        + ["--steps", "600", "--val_every", "50", "--patience", "1000",
           "--run_dir", run_dir],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    ckpt_dir = os.path.join(run_dir, "ckpt")
    killed = None
    try:
        deadline = time.time() + 120
        while time.time() < deadline and killed is None:
            steps = [n for n in (os.listdir(ckpt_dir)
                                 if os.path.isdir(ckpt_dir) else [])
                     if n.startswith("step_") and "tmp" not in n]
            child = _child_of(proc.pid)
            if steps and child is not None:
                os.kill(child, signal.SIGKILL)
                killed = max(int(n.split("_")[1]) for n in steps)
            time.sleep(0.05)
        rc = proc.wait(timeout=180)
        stderr = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert killed is not None, "no checkpoint appeared"
    assert rc == 0, stderr
    assert stderr.count("[resilient] launching") == 2, stderr
    assert "relaunching with --resume" in stderr
    recs = _records(run_dir)
    resumed = [r for r in recs if r.get("event") == "resumed"]
    assert len(resumed) == 1 and resumed[0]["step"] >= killed
    finals = [r["step"] for r in recs if "final" in r]
    assert finals and finals[-1] >= 600


def test_supervisor_forwards_sigterm_and_does_not_relaunch(tmp_path):
    run_dir = str(tmp_path / "run")
    proc = subprocess.Popen(
        SUP + ["--backoff", "0.2", "--"] + ARGS
        + ["--val_every", "1000000", "--steps", "1000000", "--run_dir",
           run_dir], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not any("loss" in r for r in _records(run_dir)):
            assert proc.poll() is None, "the run exited early"
            assert time.time() < deadline, "no loss line"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        stderr = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, stderr
    assert "terminated by request" in stderr or \
        "termination requested" in stderr
    assert stderr.count("[resilient] launching") == 1, stderr
    assert "-m mpqe_tpu_torch.train" in stderr
    assert "relaunching with --resume" not in stderr, stderr
    events = [r.get("event") for r in _records(run_dir)]
    assert "preempt_stop" in events and "final_checkpoint" in events
