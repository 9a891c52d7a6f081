"""Dense scatter-add (counterpart of ``mpqe_tpu/ops/embed.py:35``).

The reference's other scatter formulations and ``embedding_lookup`` are
measured variants of the same function and are not ported; the port's
entity gathers take autograd's dense gradient, as ``models/mpqe.py``
says.
"""

from __future__ import annotations

import torch


def scatter_add_dense(n_rows: int, idx: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """``zeros([n_rows, d]).at[idx].add(g)``: rows of ``g [m, d]`` summed
    into their ``idx`` rows; an index outside ``[0, n_rows)`` is dropped,
    as JAX's scatter drops it.  On a CUDA tensor ``index_add_`` sums with
    atomics (the last bits may vary from run to run)."""
    ids = idx.long()
    ok = (ids >= 0) & (ids < n_rows)
    out = g.new_zeros((n_rows, g.shape[-1]))
    return out.index_add(0, ids[ok], g[ok])
