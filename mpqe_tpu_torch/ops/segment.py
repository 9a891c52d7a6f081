"""Segment reductions (sum / max / mean) over rows of an edge-shaped
tensor (counterpart of ``mpqe_tpu/ops/segment.py``).

Two implementations share one API, as in the reference:

* ``backend="xla"``: plain PyTorch.  Rows whose segment id falls outside
  ``[0, n)`` are dropped (padding edges carry ``segment_id == n``); they
  are masked out before ``index_add_``, which would raise on them.
  ``index_add_`` on a CUDA tensor sums with atomics, so the last bits of a
  sum may differ from run to run there.
* ``backend="pallas"``: the hand-written kernels K4a / K4b
  (``ops/segment_kernels.py``), forward only and capped at 8,192
  segments like the reference's Pallas kernels; each segment's rows are
  added in one fixed order, so their sums are the same in every run.
  They read a layout of the rows by segment
  (``segment_kernels.segment_layout``): ``layout=`` hands over one built
  before, for a caller that reduces over the same ids more than once.
"""

from __future__ import annotations

import torch

from mpqe_tpu_torch.ops import segment_kernels

NEG_INF = -1e30
BACKENDS = ("xla", "pallas")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown segment backend {backend!r}; options: "
                         f"{BACKENDS}")


def _check_layout_backend(backend: str, layout) -> None:
    if layout is not None and backend != "pallas":
        raise ValueError("layout= is the pallas backend's; backend="
                         f"{backend!r} takes none")


def _in_range(segment_ids: torch.Tensor, n: int):
    ids = segment_ids.long()
    ok = (ids >= 0) & (ids < n)
    return ids, ok


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, backend: str = "xla",
                layout=None) -> torch.Tensor:
    """Sum rows of ``data [E, ...]`` into ``[num_segments, ...]``; rows with
    an id outside ``[0, num_segments)`` are dropped.  ``layout``: the
    pallas backend's ``segment_layout(segment_ids, num_segments)``, built
    by the kernel's wrapper when ``None``."""
    _check_backend(backend)
    _check_layout_backend(backend, layout)
    if backend == "pallas":
        return segment_kernels.segment_sum_kernel(data, segment_ids,
                                                  num_segments, layout=layout)
    ids, ok = _in_range(segment_ids, num_segments)
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, ids[ok], data[ok])


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, backend: str = "xla",
                empty_value: float = 0.0, layout=None) -> torch.Tensor:
    """Max-reduce rows into segments; a segment that is empty (or whose max
    is at or below ``NEG_INF / 2``) gets ``empty_value``.  ``layout`` as
    for :func:`segment_sum`."""
    _check_backend(backend)
    _check_layout_backend(backend, layout)
    if backend == "pallas":
        out = segment_kernels.segment_max_kernel(data, segment_ids,
                                                 num_segments, layout=layout)
    else:
        ids, ok = _in_range(segment_ids, num_segments)
        out = data.new_full((num_segments, *data.shape[1:]), float("-inf"))
        idx = ids[ok].view(-1, *([1] * (data.dim() - 1))).expand_as(data[ok])
        out = out.scatter_reduce(0, idx, data[ok], reduce="amax",
                                 include_self=True)
    return torch.where(out <= NEG_INF / 2,
                       torch.full_like(out, empty_value), out)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, backend: str = "xla",
                 layout=None) -> torch.Tensor:
    """Mean of each segment's rows (0 for an empty one); ``layout`` as for
    :func:`segment_sum`, built once here for both sums when ``None``."""
    if backend == "pallas" and layout is None:
        layout = segment_kernels.segment_layout(segment_ids, num_segments)
    s = segment_sum(data, segment_ids, num_segments, backend=backend,
                    layout=layout)
    ones = data.new_ones((data.shape[0], 1))
    cnt = segment_sum(ones, segment_ids, num_segments, backend=backend,
                      layout=layout)
    return s / torch.clamp(cnt, min=1.0)


def segment_softmax_weights(logits: torch.Tensor, segment_ids: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """Per-segment softmax over a flat ``[E]`` logit vector."""
    ids = segment_ids.long().clamp(0, num_segments - 1)
    m = segment_max(logits[:, None], segment_ids, num_segments)[:, 0]
    e = torch.exp(logits - m[ids])
    z = segment_sum(e[:, None], segment_ids, num_segments)[:, 0]
    return e / torch.clamp(z[ids], min=1e-30)
