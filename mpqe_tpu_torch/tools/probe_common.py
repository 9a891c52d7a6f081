"""What the port's measuring tools share: the device, the timed loop and
the device profile beside each timing.

* :func:`device_of`: the tool's ``--device`` (the card unless told
  otherwise; a missing card raises, nothing falls back to the CPU), with
  TF32 off, as every f32 product of the port runs.
* :func:`timed`: ``profiling.loop_time`` (overhead-cancelled seconds an
  iteration, CUDA events on the card) of ``loop(n)``, which runs its body
  n times with a data dependency threaded through, and on the card the
  device time of ``PROFILE_ITERS`` iterations by kernel
  (``profiling.device_profile``).  Eager PyTorch launches each body from
  the host: where the card's busy share is well under 1, the host sets
  the pace and the ms is the host's, not the card's.
* :data:`LOOP`: overrides of every tool's loop depth (``n_small``,
  ``n_large``, ``samples``) and profile length, None by default;
  ``chip_smoke.py`` cuts them to run every tool at its full width in a
  short time.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
import torch

PROFILE_ITERS = 3  # iterations of each timed loop profiled on the card
PROFILE_TOP = 5  # kernels listed per profile, largest first
PROFILE_TRIES = 3  # profiles taken until one records a device event

# None: each tool's own depth; chip_smoke.py sets smaller values
LOOP = dict(n_small=None, n_large=None, samples=None, profile=None)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_of(name: str) -> torch.device:
    """``--device`` as a torch device (``serve.resolve_device``: no card
    and no ``--device cpu`` raises), TF32 off on the card."""
    from mpqe_tpu_torch.serve import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def device_fields(dev: torch.device) -> dict:
    """The device a record was measured on: its type and, on the card,
    its name."""
    return {"backend": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")}


def dense_batch(n_entities: int, n_modes: int, n_rels: int, structure: str,
                B: int, n_neg: int, dev: torch.device) -> list:
    """One formula's batch from ``np.random.default_rng(0)``, drawn in the
    reference tools' order: node entities and modes ``[B, n_nodes]``,
    the formula's relations and unit norms ``[n_edges]``, targets ``[B]``,
    negatives ``[B, n_neg]`` and all-ones masks; int32 and f32 tensors on
    ``dev``."""
    from mpqe_tpu_torch.queries import STRUCTURES

    spec = STRUCTURES[structure]
    rng = np.random.default_rng(0)
    arrays = (
        rng.integers(0, n_entities, (B, spec.n_nodes)).astype(np.int32),
        rng.integers(0, n_modes, (B, spec.n_nodes)).astype(np.int32),
        rng.integers(0, n_rels, (spec.n_edges,)).astype(np.int32),
        np.ones((spec.n_edges,), np.float32),
        rng.integers(0, n_entities, (B,)).astype(np.int32),
        rng.integers(0, n_entities, (B, n_neg)).astype(np.int32),
        np.ones((B, n_neg), np.float32),
        np.ones((B,), np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def profile_fields(loop: Callable, dev: torch.device,
                   n: Optional[int] = None) -> dict:
    """Device ms an iteration of ``loop(n)`` by kernel, the card's busy
    share of the wall time and the host's wall ms an iteration; on the
    CPU these are not measured (None)."""
    if dev.type != "cuda":
        return {"device_ms": None, "busy_share": None, "wall_ms": None,
                "kernels": None}
    from mpqe_tpu_torch.utils import profiling

    n = n or LOOP["profile"] or PROFILE_ITERS
    for attempt in range(PROFILE_TRIES):
        wall_us, rows = profiling.device_profile(lambda: loop(n))
        busy = sum(r[0] for r in rows)
        if busy > 0:
            break
        log(f"profile {attempt + 1}: no device event recorded")
    return {"device_ms": busy / 1e3 / n,
            "busy_share": busy / wall_us if wall_us > 0 else None,
            "wall_ms": wall_us / 1e3 / n,
            "kernels": [{"name": key[:120], "ms": us / 1e3 / n,
                         "launches": count / n}
                        for us, count, key in rows[:PROFILE_TOP]]}


def timed(loop: Callable, dev: torch.device, n_small: int = 5,
          n_large: int = 55, samples: int = 3, profile: bool = True) -> dict:
    """``{"ms": ...}``: ``profiling.loop_time`` of ``loop(n)`` (the
    tool's depth unless :data:`LOOP` overrides it), and with ``profile``
    the fields of :func:`profile_fields`."""
    from mpqe_tpu_torch.utils import profiling

    n_small = LOOP["n_small"] or n_small
    n_large = max(LOOP["n_large"] or n_large, n_small + 1)
    samples = LOOP["samples"] or samples
    dt = profiling.loop_time(loop, n_small=n_small, n_large=n_large,
                             samples=samples, log=log, device=dev)
    out = {"ms": dt * 1e3}
    if profile:
        out.update(profile_fields(loop, dev))
    return out
