"""Entity-table lookup with a selectable backward scatter (counterpart of
``mpqe_tpu/ops/embed.py``).

:func:`embedding_lookup` is ``table[idx]`` whose gradient is summed into
the table by one of three formulations of the same scatter-add:
``dense`` (rows added in the given order), ``sorted`` (rows first sorted
by index, stably) and ``dedup`` (sorted, rows of one index summed, then
one row added per distinct index).  They differ only in the order of the
sums; ``models/mpqe.py`` takes them for the shared-negatives loss and
``dense_batch_loss_fused``.  On a CUDA tensor the adds are ``index_add_``
with atomics (the last bits may vary from run to run).
"""

from __future__ import annotations

import torch


def scatter_add_dense(n_rows: int, idx: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """``zeros([n_rows, d]).at[idx].add(g)``: rows of ``g [m, d]`` summed
    into their ``idx`` rows; an index outside ``[0, n_rows)`` is dropped,
    as JAX's scatter drops it."""
    ids = idx.long()
    ok = (ids >= 0) & (ids < n_rows)
    out = g.new_zeros((n_rows, g.shape[-1]))
    return out.index_add(0, ids[ok], g[ok])


def scatter_add_sorted(n_rows: int, idx: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_add_dense` over the rows sorted by index (stable,
    as ``jnp.argsort``)."""
    order = torch.argsort(idx.long(), stable=True)
    return scatter_add_dense(n_rows, idx[order], g[order])


def scatter_add_dedup(n_rows: int, idx: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """Sort by index, sum the rows of each index (a segment sum in sorted
    order), then add one row per distinct index; out-of-range indices
    are dropped."""
    m, d = g.shape
    ids = idx.long()
    order = torch.argsort(ids, stable=True)
    idx_s, g_s = ids[order], g[order]
    head = torch.ones((m,), dtype=torch.bool, device=g.device)
    if m > 1:
        head[1:] = idx_s[1:] != idx_s[:-1]
    seg = torch.cumsum(head.long(), 0) - 1  # [m], segment id per row
    sums = g.new_zeros((m, d)).index_add(0, seg, g_s)
    n_seg = int(head.sum()) if m else 0
    rep = idx_s[head]  # the distinct indices, ascending
    return scatter_add_dense(n_rows, rep, sums[:n_seg])


SCATTERS = {
    "dense": scatter_add_dense,
    "sorted": scatter_add_sorted,
    "dedup": scatter_add_dedup,
}


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, grad_scatter):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        ctx.grad_scatter = grad_scatter
        return table[idx.long().clamp(0, table.shape[0] - 1)]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = g.shape[-1]
        dtable = SCATTERS[ctx.grad_scatter](ctx.n_rows, idx.reshape(-1),
                                            g.reshape(-1, d))
        return dtable, None, None


def embedding_lookup(table: torch.Tensor, idx: torch.Tensor,
                     grad_scatter: str = "dense") -> torch.Tensor:
    """``table[idx]`` (any integer shape of ``idx``; the result is
    ``idx.shape + (d,)``), indices clamped into range as JAX's gather
    clamps them; its gradient is a dense ``[n_rows, d]`` tensor summed by
    ``SCATTERS[grad_scatter]`` (an out-of-range index adds nothing, as
    the reference's scatter drops it)."""
    if grad_scatter not in SCATTERS:
        raise ValueError(f"unknown grad_scatter {grad_scatter!r}")
    return _Lookup.apply(table, idx, grad_scatter)
