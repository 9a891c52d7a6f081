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
tensors only.  The kernels read a layout of the rows by segment,
:func:`segment_layout`: a stable sort of the rows by id, itself a
hand-written kernel (``segment_layout_kernel``, counted in
``segment_layout.launches``; plain version
:func:`segment_layout_reference`, a stable ``torch.sort``).  Each
reduction takes it as ``layout=(perm, offs)`` or builds it: a caller
that reduces over the same ids more than once (a sparse encode's layers
all sum into the same destinations) builds it once.  The kernel then
gives each (segment, column tile) one owner that adds its rows in
ascending row order, one rounding per add and no atomics.  The plain
version adds in the same order (one ``index_add_`` per rank within a
segment, whose indices are distinct), so the two agree bit for bit on
the card, and the sum does not vary from run to run.  On the card a call
is the output's allocation and one launch with a layout given, two
without; nothing is copied when ``data`` is contiguous f32 and the ids
int32 or int64, and nothing waits for the device.

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
def segment_layout_reference(segment_ids: torch.Tensor, num_segments: int):
    """Plain version of the layout kernel, on the ids' device without a
    host sync: ``perm [E]`` int32, the row numbers stably sorted by
    segment (rows out of range last, in row order), and ``offs
    [num_segments + 1]`` int32, segment s's range ``perm[offs[s]:offs[s +
    1]]``."""
    ids = segment_ids.long()
    key = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    keys, perm = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, device=ids.device)
    offs = torch.searchsorted(keys, bounds)
    return perm.to(torch.int32), offs.to(torch.int32)


def _ranked_rows(segment_ids: torch.Tensor, num_segments: int, layout):
    """The in-range rows stably sorted by segment: ``(keys, rows, rank)``,
    ``rank`` the position of a row within its segment; from ``layout``
    (built here when ``None``)."""
    perm, offs = (segment_layout_reference(segment_ids, num_segments)
                  if layout is None else layout)
    offs = offs.long()
    n_in = int(offs[-1])
    keys = torch.repeat_interleave(
        torch.arange(num_segments, device=offs.device), offs.diff(),
        output_size=n_in)
    rank = torch.arange(n_in, device=offs.device) - offs[keys]
    return keys, perm[:n_in].long(), rank


def segment_sum_reference(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int, layout=None) -> torch.Tensor:
    """Plain version of K4a: each segment's rows added in ascending row
    order from 0 in f32 (one ``index_add_`` per rank within a segment).
    ``layout``: the ids' ``(perm, offs)``, as the kernel takes it."""
    x = data.to(torch.float32)
    out = x.new_zeros((num_segments, x.shape[1]))
    keys, rows, rank = _ranked_rows(segment_ids, num_segments, layout)
    if keys.numel():
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            out.index_add_(0, keys[sel], x[rows[sel]])
    return out.to(data.dtype)


def segment_max_reference(data: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int, layout=None) -> torch.Tensor:
    """Plain version of K4b: ``torch.maximum`` (NaN propagates) from
    :data:`NEG_INF`, over each segment's rows (``layout`` as for
    :func:`segment_sum_reference`)."""
    x = data.to(torch.float32)
    out = x.new_full((num_segments, x.shape[1]), NEG_INF)
    keys, rows, rank = _ranked_rows(segment_ids, num_segments, layout)
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
        lib.mpqe_segment_layout.argtypes = [p, i, i, i, p, p, p, p]
        lib.mpqe_segment_layout.restype = i
        lib.mpqe_segment_layout_scratch.argtypes = [i, i]
        lib.mpqe_segment_layout_scratch.restype = ctypes.c_longlong
        _KERNEL = lib
    return _KERNEL


def _cuda_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def segment_layout(segment_ids: torch.Tensor, num_segments: int):
    """The layout K4a / K4b read: ``(perm [E] int32, offs [num_segments +
    1] int32)`` as :func:`segment_layout_reference` gives it.  CUDA ids:
    ``segment_layout_kernel`` (``csrc/segment.cu``: a key histogram for
    ``offs``, a radix sort in shared memory for ``perm``; three launches
    above 8,192 rows; no host sync), counted once a call in
    ``segment_layout.launches``; CPU ids: the plain version."""
    _check_cap(num_segments)
    if segment_ids.dim() != 1 or segment_ids.is_floating_point() or \
            segment_ids.is_complex():
        raise ValueError(f"segment_ids must be a 1-d integer tensor; got "
                         f"{segment_ids.dtype} {tuple(segment_ids.shape)}")
    if segment_ids.device.type == "cpu":
        return segment_layout_reference(segment_ids, num_segments)
    _cuda_device("segment_layout", segment_ids)
    ids = segment_ids if segment_ids.dtype in (torch.int32, torch.int64) \
        else segment_ids.to(torch.int32)
    ids = ids.contiguous()
    dev, E = ids.device, ids.shape[0]
    if E >= 1 << 31:
        raise ValueError(f"segment_layout: {E} rows exceed int32 row numbers")
    lib = _kernel()
    perm = torch.empty(E, dtype=torch.int32, device=dev)
    offs = torch.empty(num_segments + 1, dtype=torch.int32, device=dev)
    n_scratch = lib.mpqe_segment_layout_scratch(E, num_segments)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev) \
        if n_scratch else None
    with torch.cuda.device(dev):
        err = lib.mpqe_segment_layout(
            ids.data_ptr(), int(ids.dtype == torch.int64), E, num_segments,
            None if scratch is None else scratch.data_ptr(),
            perm.data_ptr(), offs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 layout kernel launch failed: cudaError {err}")
    segment_layout.launches += 1
    return perm, offs


segment_layout.launches = 0


def _check_layout(layout, n_rows: int, num_segments: int, dev) -> None:
    perm, offs = layout
    for name, t, n in (("perm", perm, n_rows),
                       ("offs", offs, num_segments + 1)):
        if t.shape != (n,) or t.dtype != torch.int32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"layout {name} must be a contiguous int32 [{n}] on {dev}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(name: str, entry: str, data: torch.Tensor,
            segment_ids: torch.Tensor, num_segments: int, layout):
    """(output in ``data``'s dtype, whether the kernel was launched: an
    empty output needs no launch, and no layout)."""
    dev = data.device
    if segment_ids.device != dev:
        raise ValueError(f"segment_ids is on {segment_ids.device}, data on "
                         f"{dev}")
    x = data.to(torch.float32).contiguous()
    lib = _kernel()
    out = torch.empty((num_segments, x.shape[1]), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out.to(data.dtype), False
    if layout is None:
        layout = segment_layout(segment_ids, num_segments)
    _check_layout(layout, x.shape[0], num_segments, dev)
    perm, offs = layout
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            x.data_ptr(), perm.data_ptr(), offs.data_ptr(), num_segments,
            x.shape[1], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out.to(data.dtype), True


def segment_sum_kernel(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, layout=None) -> torch.Tensor:
    """K4a: ``[num_segments, d]`` sums of the rows of ``data [E, d]`` by
    ``segment_ids [E]`` (out-of-range ids dropped), in ``data``'s dtype.
    ``layout``: :func:`segment_layout` of these ids and ``num_segments``,
    built here when ``None``.  CUDA tensors: the kernel, counted in
    ``segment_sum_kernel.launches``; CPU tensors: the plain version."""
    refuse_grad("segment_sum_kernel", data)
    _check_args(data, segment_ids, num_segments)
    if data.device.type == "cpu":
        return segment_sum_reference(data, segment_ids, num_segments, layout)
    _cuda_device("segment_sum_kernel", data)
    out, launched = _launch("K4a", "mpqe_segment_sum", data, segment_ids,
                            num_segments, layout)
    segment_sum_kernel.launches += int(launched)
    return out


segment_sum_kernel.launches = 0


def segment_max_kernel(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, layout=None) -> torch.Tensor:
    """K4b: ``[num_segments, d]`` maxima of the rows of ``data [E, d]`` by
    ``segment_ids [E]`` from :data:`NEG_INF` (an empty segment stays at
    -1e30; NaN propagates), in ``data``'s dtype; ``layout`` as for
    :func:`segment_sum_kernel`.  CUDA tensors: the kernel, counted in
    ``segment_max_kernel.launches``; CPU tensors: the plain version."""
    refuse_grad("segment_max_kernel", data)
    _check_args(data, segment_ids, num_segments)
    if data.device.type == "cpu":
        return segment_max_reference(data, segment_ids, num_segments, layout)
    _cuda_device("segment_max_kernel", data)
    out, launched = _launch("K4b", "mpqe_segment_max", data, segment_ids,
                            num_segments, layout)
    segment_max_kernel.launches += int(launched)
    return out


segment_max_kernel.launches = 0
