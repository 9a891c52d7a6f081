"""Which device events does a short ``torch.profiler`` window drop?

``chip_smoke.py``'s ``device_ms`` takes a kernel's device time from a
profile of a few calls (a warmup step, then one recorded step).  Some of
those profiles record fewer launches than were made, and a few record
none.  This probe shows where in the recorded step the lost launches
are, and whether idle host time at both ends of that step ("a pad")
keeps them.

Each repetition profiles ``CALLS`` element-wise kernels of distinct names
(``exp``, ``sin``, ``cos``, ``tanh``, ``sigmoid``, in launch order) on a
256 MiB tensor, each after an L2 flush, under the schedule ``device_ms``
uses; repetitions alternate between the pads given, so both see the same
card and the same host.  It prints, per pad, the profiles with a launch
missing and the misses by launch position, then one JSON line.

    python -m mpqe_tpu_torch.tools.profile_probe [--reps 300]
        [--pads 0,0.05]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

OPS = ("exp", "sin", "cos", "tanh", "sigmoid")


def profile_once(xs, out, flush, pad: float) -> list:
    """The names of ``OPS`` whose kernels the recorded step holds, as a
    list of booleans in launch order."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def calls():
        for name in OPS:
            flush.zero_()
            getattr(torch, name)(xs, out=out)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        calls()
        prof.step()
        time.sleep(pad)
        calls()
        time.sleep(pad)
        prof.step()
    names = [e.key.lower() for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return [any(f"{op}_kernel" in n for n in names) for op in OPS]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=300)
    p.add_argument("--pads", default="0,0.05",
                   help="seconds of host idle time at each end of the "
                        "recorded step, comma-separated")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_probe: no CUDA device", file=sys.stderr)
        return 1
    pads = [float(s) for s in args.pads.split(",")]
    dev = torch.device("cuda")
    xs = torch.rand(1 << 26, device=dev)
    out = torch.empty_like(xs)
    flush = torch.empty((512 << 20) // 4, device=dev)
    if not all(profile_once(xs, out, flush, 0.05)):
        print("profile_probe: a padded first profile missed a kernel; "
              "the kernel names may differ in this torch", file=sys.stderr)
    tally = {pad: {"profiles": 0, "short": 0, "empty": 0,
                   "missed_by_position": [0] * len(OPS)} for pad in pads}
    t0 = time.perf_counter()
    for rep in range(args.reps):
        for pad in pads:
            seen = profile_once(xs, out, flush, pad)
            t = tally[pad]
            t["profiles"] += 1
            t["short"] += not all(seen)
            t["empty"] += not any(seen)
            for i, s in enumerate(seen):
                t["missed_by_position"][i] += not s
    for pad, t in tally.items():
        print(f"pad={pad:.3f} s: {t['short']} of {t['profiles']} profiles "
              f"missed a launch, {t['empty']} missed all; misses by launch "
              f"position {t['missed_by_position']}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "ops": OPS,
                      "seconds": time.perf_counter() - t0,
                      "tally": {str(k): v for k, v in tally.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
