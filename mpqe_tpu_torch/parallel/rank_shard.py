"""Candidate scoring under the table's dtype (counterpart of
``mpqe_tpu/parallel/rank_shard.py``).

Only the float32 table is ported; the bfloat16 and int8 candidate tables
are ROADMAP Queue 1 item 5, and the sharded rank/top-k is item 8.
"""

from __future__ import annotations

import torch

_QUANTIZED_LATER = (
    "table_dtype={!r} is not ported yet: the bfloat16/int8 candidate "
    "tables are ROADMAP Queue 1 item 5")


def check_table_dtype(table_dtype: str) -> None:
    """Raise unless ``table_dtype`` is the one ported so far."""
    if table_dtype in ("bfloat16", "int8"):
        raise NotImplementedError(_QUANTIZED_LATER.format(table_dtype))
    if table_dtype != "float32":
        raise ValueError(f"unknown table_dtype {table_dtype!r}")


def quantized_scores(q: torch.Tensor, table_t: torch.Tensor,
                     table_dtype: str) -> torch.Tensor:
    """``q @ table_t`` under the table's dtype: ``[B, d] @ [d, N]`` in
    float32.  On the card this is one cuBLAS product; float32 parity
    with the reference needs TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default)."""
    check_table_dtype(table_dtype)
    return torch.matmul(q, table_t)


def quantize_rows(ent_norm: torch.Tensor, table_dtype: str) -> torch.Tensor:
    """Quantize PRE-normalized candidate rows (float32: unchanged)."""
    check_table_dtype(table_dtype)
    return ent_norm
