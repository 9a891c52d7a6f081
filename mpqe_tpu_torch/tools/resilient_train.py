#!/usr/bin/env python3
"""Crash-supervised training: relaunch the train CLI with ``--resume`` on
failure (counterpart of ``tools/resilient_train.py``).

A run can lose its process mid-training (a device fault, the host's
out-of-memory killer); the train CLI checkpoints its full state (model,
optimizer, step; ``train/checkpoint.py``) and ``--resume`` restarts from
the latest checkpoint, so the supervisor loop is simple:

  run the train CLI -> nonzero exit? -> backoff -> relaunch with --resume

It launches ``python -m mpqe_tpu_torch.train`` (from the working
directory, so run it from the repository's root), or ``python
<--train_script>`` when one is given (a stand-in script in tests).  The
backoff doubles per consecutive failure, capped at 8x; a run that lasted
``--min_uptime`` resets the count; after ``--max_restarts`` relaunches
it gives up with the last exit code.  SIGTERM is forwarded to the child
(which checkpoints and exits 0) and never leads to a relaunch.

Usage:
  python -m mpqe_tpu_torch.tools.resilient_train [supervisor flags] -- \\
      <train CLI args>
  python -m mpqe_tpu_torch.tools.resilient_train --max_restarts 5 -- \\
      --data synthetic --steps 100000 --run_dir runs/big
"""

from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        raise SystemExit("usage: resilient_train.py [flags] -- <train args>")
    split = argv.index("--")
    sup_args, train_args = argv[:split], argv[split + 1:]

    ap = argparse.ArgumentParser()
    ap.add_argument("--max_restarts", type=int, default=10)
    ap.add_argument("--backoff", type=float, default=5.0,
                    help="seconds before a relaunch (doubles per "
                         "consecutive failure, capped at 8x)")
    ap.add_argument("--min_uptime", type=float, default=60.0,
                    help="a run that lasted at least this long resets "
                         "the consecutive-failure counter")
    ap.add_argument("--python", default=sys.executable)
    ap.add_argument("--train_script", default=None,
                    help="a script to run instead of python -m "
                         "mpqe_tpu_torch.train")
    args = ap.parse_args(sup_args)

    if "--run_dir" not in train_args:
        raise SystemExit("--run_dir is required in the train args "
                         "(resume needs a stable checkpoint directory)")

    # graceful preemption passes through the supervisor: SIGTERM goes to
    # the child (the train CLI checkpoints and exits 0), and once
    # termination was requested nothing is relaunched, whatever the
    # child's exit code (the signal may land before the child installs
    # its handler: still a shutdown, not a crash)
    child = None
    stop_requested = False

    def _forward(sig, frame):
        nonlocal stop_requested
        stop_requested = True
        if child is not None and child.poll() is None:
            child.send_signal(sig)

    signal.signal(signal.SIGTERM, _forward)

    launcher = ([args.python, args.train_script] if args.train_script
                else [args.python, "-m", "mpqe_tpu_torch.train"])
    restarts, consecutive = 0, 0
    resume_args = list(train_args)
    while True:
        if stop_requested:
            print("[resilient] termination requested; not (re)launching",
                  file=sys.stderr, flush=True)
            return 0
        t0 = time.monotonic()
        cmd = launcher + resume_args
        print(f"[resilient] launching (restart {restarts}): "
              f"{' '.join(cmd)}", file=sys.stderr, flush=True)
        child = subprocess.Popen(cmd)
        # a SIGTERM between the loop-top check and Popen found no child to
        # forward to: check again now that it exists (the train CLI
        # tolerates a second SIGTERM)
        if stop_requested and child.poll() is None:
            child.send_signal(signal.SIGTERM)
        rc = child.wait()
        uptime = time.monotonic() - t0
        if stop_requested:
            print(f"[resilient] terminated by request (child rc={rc}); "
                  "not relaunching", file=sys.stderr, flush=True)
            return 0 if rc == 0 else rc
        if rc == 0:
            print(f"[resilient] training completed (uptime {uptime:.0f}s)",
                  file=sys.stderr, flush=True)
            return 0
        consecutive = 0 if uptime >= args.min_uptime else consecutive + 1
        restarts += 1
        if restarts > args.max_restarts:
            print(f"[resilient] giving up after {args.max_restarts} "
                  f"restarts (last rc={rc})", file=sys.stderr, flush=True)
            return rc
        if "--resume" not in resume_args:
            resume_args = resume_args + ["--resume"]
        delay = min(args.backoff * (2 ** consecutive), args.backoff * 8)
        print(f"[resilient] rc={rc} after {uptime:.0f}s; relaunching "
              f"with --resume in {delay:.0f}s", file=sys.stderr, flush=True)
        time.sleep(delay)


if __name__ == "__main__":
    sys.exit(main())
