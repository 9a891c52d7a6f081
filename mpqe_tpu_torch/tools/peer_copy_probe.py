#!/usr/bin/env python3
"""The copy of a K8 hop between two cards with peer access off and on.

In a fresh process (no peer access enabled yet) it times ``cuMemcpyAsync``
of K8's hop blocks at the flagship width (16 MiB at P = 2, 8 MiB at P =
4, the general graph of ``chip_smoke.py``) from cuda:0 to cuda:1 on a
stream of cuda:1: first as the driver stages it without peer access,
then after ``parallel/ipc.py peer_access`` (the copy K8 makes).  Beside
each: the bound, the bytes over one direction of the card's NVLink as
``nvidia-smi nvlink --status`` reports it.  One JSON line; needs two
cards (exit 1 otherwise).

  python -m mpqe_tpu_torch.tools.peer_copy_probe
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

BLOCKS = {"P=2": 16 << 20, "P=4": 8 << 20}  # bytes of a hop's block
ITERS = 20


def nvlink_gbps(card: int = 0):
    """(GB/s one direction, links) of the card's NVLink, or (None, 0)."""
    out = subprocess.run(["nvidia-smi", "nvlink", "--status", "-i",
                          str(card)], capture_output=True, text=True,
                         timeout=60).stdout
    rates = [float(x) for x in re.findall(r"Link \d+: ([\d.]+) GB/s", out)]
    return (sum(rates), len(rates)) if rates else (None, 0)


def copy_ms(dst: torch.Tensor, src: torch.Tensor) -> float:
    """Mean ms of ``ITERS`` copies ``src -> dst`` on dst's current stream
    (CUDA events; one warm-up copy)."""
    from mpqe_tpu_torch.parallel import ipc

    stream = torch.cuda.current_stream(dst.device)
    ipc.copy_into(dst.data_ptr(), src, stream)
    with torch.cuda.device(dst.device):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        for _ in range(ITERS):
            ipc.copy_into(dst.data_ptr(), src, stream)
        b.record(stream)
    b.synchronize()
    return a.elapsed_time(b) / ITERS


def main(argv=None) -> int:
    from mpqe_tpu_torch.parallel import ipc

    if torch.cuda.device_count() < 2:
        print("peer_copy_probe: needs two cards", file=sys.stderr)
        return 1
    gbps, links = nvlink_gbps(0)
    src = torch.randn(max(BLOCKS.values()) // 4, device="cuda:0")
    dst = torch.empty(src.shape, device="cuda:1")
    rec = {"device_name": torch.cuda.get_device_name(0),
           "cards": torch.cuda.device_count(),
           "can_access_peer": torch.cuda.can_device_access_peer(0, 1),
           "nvlink_gbps_one_direction": gbps, "nvlink_links": links}
    for state in ("off", "on"):
        if state == "on":
            ipc.peer_access(0, 1)
        for name, n in BLOCKS.items():
            ms = copy_ms(dst[:n // 4], src[:n // 4])
            rec[f"{name}_peer_{state}_ms"] = ms
            rec[f"{name}_peer_{state}_gbps"] = n / ms / 1e6
    torch.cuda.synchronize(1)
    rec["equal"] = bool(torch.equal(dst.cpu(), src.cpu()))
    for name, n in BLOCKS.items():
        rec[f"{name}_bound_ms"] = n / (gbps * 1e9) * 1e3 if gbps else None
    print(json.dumps(rec), flush=True)
    return 0 if rec["equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
