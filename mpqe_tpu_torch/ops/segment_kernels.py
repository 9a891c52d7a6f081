"""Segment sum and max (counterpart of ``mpqe_tpu/ops/pallas_segment.py``):
K4a and K4b as Hopper CUDA kernels.

* K4a :func:`segment_sum_kernel` (reference ``segment_sum_pallas`` :56):
  ``out[s] = sum of data[e] over the rows with id_e == s``;
* K4b :func:`segment_max_kernel` (reference ``segment_max_pallas`` :120):
  ``out[s] = max(-1e30, data[e] ...)``, an empty segment left at
  :data:`NEG_INF` = -1e30 (not ``-inf``), a NaN term giving NaN.

Both take ``data [E, d]`` and ``segment_ids [E]``, drop the rows whose id
lies outside ``[0, num_segments)``, accumulate in f32 and return
``[num_segments, d]`` in ``data``'s dtype.  As in the reference, a padded
segment count (a multiple of 8) over :data:`MAX_PALLAS_SEGMENTS` raises
``ValueError``; the reference's TPU tiling arguments (``chunk``,
``s_tile``, ``interpret``) have no counterpart.

Each wrapper launches ``csrc/segment.cu`` (built at first use) for CUDA
tensors, counted in its ``launches``, and runs its plain PyTorch version
(:func:`segment_sum_reference`, :func:`segment_max_reference`) for CPU
tensors only.  The wrapper lays the rows out by segment first (a stable
sort of the ids and each segment's range, :func:`segment_layout`); the
kernel then gives each (segment, column tile) one owner that adds its
rows in ascending row order, one rounding per add and no atomics.  The
plain version adds in the same order (one ``index_add_`` per rank within
a segment, whose indices are distinct), so the two agree bit for bit on
the card, and the sum does not vary from run to run.

Like the reference kernels, both are forward only: a call in grad mode
with an input that requires grad raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

from mpqe_tpu_torch.ops import cuda_build
from mpqe_tpu_torch.ops.cuda_build import refuse_grad
from mpqe_tpu_torch.ops.edge_store import round_up

NEG_INF = -1e30
MAX_PALLAS_SEGMENTS = 8192
PAD = 8  # the reference pads the segment count to a multiple of 8


def _check_cap(num_segments: int) -> None:
    """The reference's cap: ``ValueError`` when the padded segment count
    exceeds :data:`MAX_PALLAS_SEGMENTS`."""
    if round_up(max(num_segments, PAD), PAD) > MAX_PALLAS_SEGMENTS:
        raise ValueError(
            f"num_segments {num_segments} too large for the segment kernel "
            f"(cap {MAX_PALLAS_SEGMENTS}); use backend='xla'")


def _check_args(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> None:
    _check_cap(num_segments)
    if data.dim() != 2 or segment_ids.dim() != 1 or \
            segment_ids.shape[0] != data.shape[0]:
        raise ValueError(f"data must be [E, d] and segment_ids [E]; got "
                         f"{tuple(data.shape)} and {tuple(segment_ids.shape)}")
    if not data.is_floating_point():
        raise ValueError(f"data must be floating point, got {data.dtype}")
    if segment_ids.is_floating_point() or segment_ids.is_complex():
        raise ValueError(f"segment_ids must be integers, got "
                         f"{segment_ids.dtype}")


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------
def _ranked_rows(segment_ids: torch.Tensor, num_segments: int):
    """The in-range rows stably sorted by segment: ``(keys, rows, rank)``,
    ``rank`` the position of a row within its segment."""
    ids = segment_ids.long()
    rows = torch.nonzero((ids >= 0) & (ids < num_segments)).squeeze(1)
    keys, perm = torch.sort(ids[rows], stable=True)
    pos = torch.arange(keys.numel(), device=keys.device)
    start = torch.ones_like(keys, dtype=torch.bool)
    start[1:] = keys[1:] != keys[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    return keys, rows[perm], rank


def segment_sum_reference(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Plain version of K4a: each segment's rows added in ascending row
    order from 0 in f32 (one ``index_add_`` per rank within a segment)."""
    x = data.to(torch.float32)
    out = x.new_zeros((num_segments, x.shape[1]))
    keys, rows, rank = _ranked_rows(segment_ids, num_segments)
    if keys.numel():
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            out.index_add_(0, keys[sel], x[rows[sel]])
    return out.to(data.dtype)


def segment_max_reference(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Plain version of K4b: ``torch.maximum`` (NaN propagates) from
    :data:`NEG_INF`, over each segment's rows."""
    x = data.to(torch.float32)
    out = x.new_full((num_segments, x.shape[1]), NEG_INF)
    keys, rows, rank = _ranked_rows(segment_ids, num_segments)
    if keys.numel():
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            k = keys[sel]
            out[k] = torch.maximum(out[k], x[rows[sel]])
    return out.to(data.dtype)


# ----------------------------------------------------------------------
# The kernels
# ----------------------------------------------------------------------
_KERNEL = None


def _kernel():
    """The built K4 library, its entry points' argument types set."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("segment", ["segment.cu"])
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.mpqe_segment_sum, lib.mpqe_segment_max):
            fn.argtypes = [p, p, p, i, i, p, p]
            fn.restype = i
        _KERNEL = lib
    return _KERNEL


def segment_layout(segment_ids: torch.Tensor, num_segments: int):
    """The kernels' layout, made on the ids' device without a host sync:
    ``perm [E]`` int32, the row numbers stably sorted by segment (rows out
    of range last), and ``offs [num_segments + 1]`` int32, segment s's
    range ``perm[offs[s]:offs[s + 1]]``."""
    ids = segment_ids.long()
    key = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    keys, perm = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, device=ids.device)
    offs = torch.searchsorted(keys, bounds)
    return perm.to(torch.int32), offs.to(torch.int32)


def _launch(name: str, entry: str, data: torch.Tensor,
            segment_ids: torch.Tensor, num_segments: int):
    """(output in ``data``'s dtype, whether the kernel was launched: an
    empty output needs no launch)."""
    dev = data.device
    if segment_ids.device != dev:
        raise ValueError(f"segment_ids is on {segment_ids.device}, data on "
                         f"{dev}")
    x = data.to(torch.float32).contiguous()
    lib = _kernel()
    perm, offs = segment_layout(segment_ids, num_segments)
    out = torch.empty((num_segments, x.shape[1]), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out.to(data.dtype), False
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            x.data_ptr(), perm.data_ptr(), offs.data_ptr(), num_segments,
            x.shape[1], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out.to(data.dtype), True


def segment_sum_kernel(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """K4a: ``[num_segments, d]`` sums of the rows of ``data [E, d]`` by
    ``segment_ids [E]`` (out-of-range ids dropped), in ``data``'s dtype.
    CUDA tensors: the kernel, counted in ``segment_sum_kernel.launches``;
    CPU tensors: the plain version."""
    refuse_grad("segment_sum_kernel", data)
    _check_args(data, segment_ids, num_segments)
    if data.device.type == "cpu":
        return segment_sum_reference(data, segment_ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"segment_sum_kernel: unsupported device "
                         f"{data.device}")
    out, launched = _launch("K4a", "mpqe_segment_sum", data, segment_ids,
                            num_segments)
    segment_sum_kernel.launches += int(launched)
    return out


segment_sum_kernel.launches = 0


def segment_max_kernel(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """K4b: ``[num_segments, d]`` maxima of the rows of ``data [E, d]`` by
    ``segment_ids [E]`` from :data:`NEG_INF` (an empty segment stays at
    -1e30; NaN propagates), in ``data``'s dtype.  CUDA tensors: the
    kernel, counted in ``segment_max_kernel.launches``; CPU tensors: the
    plain version."""
    refuse_grad("segment_max_kernel", data)
    _check_args(data, segment_ids, num_segments)
    if data.device.type == "cpu":
        return segment_max_reference(data, segment_ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"segment_max_kernel: unsupported device "
                         f"{data.device}")
    out, launched = _launch("K4b", "mpqe_segment_max", data, segment_ids,
                            num_segments)
    segment_max_kernel.launches += int(launched)
    return out


segment_max_kernel.launches = 0
