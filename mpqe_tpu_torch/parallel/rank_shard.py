"""Candidate scoring under the table's dtype (counterpart of
``mpqe_tpu/parallel/rank_shard.py``): the float32, bfloat16 and int8
candidate tables of the rank product, their formulas in one place
(:func:`quantized_scores`, :func:`quantize_rows`, :func:`quantize_table`).

The rank product stays a library call, as the reference leaves it to
XLA outside any Pallas kernel: ``torch.mm`` for float32 and bfloat16
(an f32 result from bf16 operands: ``out_dtype=torch.float32`` on the
card, operands taken up to f32 on the CPU), ``torch._int_mm`` for int8
(int32 sums, exact here).  The sharded rank/top-k is ROADMAP Queue 1
item 8.
"""

from __future__ import annotations

import torch

TABLE_DTYPES = ("float32", "bfloat16", "int8")

# torch._int_mm on the card: rows of the first operand above this, and
# the inner and column counts multiples of 8
INT_MM_MIN_ROWS = 17


def check_table_dtype(table_dtype: str) -> None:
    """``ValueError`` for a table dtype the rank product does not take."""
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(f"unknown table_dtype {table_dtype!r}")


def _int8_scores(q8: torch.Tensor, table_t: torch.Tensor) -> torch.Tensor:
    """``q8 [B, d] @ table_t [d, N]`` with int32 sums.  On the card
    ``torch._int_mm`` wants more than 16 rows and d and N multiples of 8:
    a smaller batch is padded with zero rows, and a width it does not
    take raises."""
    if q8.is_cuda:
        d, n = table_t.shape
        if d % 8 or n % 8:
            raise ValueError(
                f"int8 rank product on the card needs d and n_entities "
                f"multiples of 8, got d={d}, n_entities={n}")
        B = q8.shape[0]
        if B < INT_MM_MIN_ROWS:
            q8 = torch.cat([q8, q8.new_zeros((INT_MM_MIN_ROWS - B, d))])
            return torch._int_mm(q8, table_t)[:B]
    return torch._int_mm(q8, table_t)


def quantized_scores(q: torch.Tensor, table_t: torch.Tensor,
                     table_dtype: str) -> torch.Tensor:
    """``[B, N]`` f32 scores ``q @ table_t`` under the table's dtype.
    ``q`` is f32 (normalized by the caller when cosine-scoring),
    ``table_t`` the ``[d, N]`` table from :func:`quantize_rows`:

    * int8: ``q8 = round(clip(q, -1, 1) * 127)`` (round half to even, as
      ``jnp.round``), int32 sums (``127² · d`` is far inside int32, so they
      are exact), times ``1 / 127²``: bit-equal to the reference;
    * bfloat16: ``bf16(q) @ table_t`` with an f32 result (the products
      are exact in f32; only the sum order differs from the reference's);
    * float32: ``q @ table_t`` in f32 (TF32 off, the card's default)."""
    check_table_dtype(table_dtype)
    if table_dtype == "int8":
        q8 = torch.round(torch.clamp(q, -1.0, 1.0) * 127.0).to(torch.int8)
        s = _int8_scores(q8, table_t)
        return s.to(torch.float32) * (1.0 / (127.0 * 127.0))
    if table_dtype == "bfloat16":
        from mpqe_tpu_torch.ops.dtypes import dot_f32

        return dot_f32(q.to(torch.bfloat16), table_t)
    return torch.matmul(q, table_t)


def quantize_rows(ent_norm: torch.Tensor, table_dtype: str) -> torch.Tensor:
    """Quantize PRE-normalized candidate rows: bfloat16 rounds them,
    int8 takes ``round(x * 127)``, float32 leaves them."""
    if table_dtype == "bfloat16":
        return ent_norm.to(torch.bfloat16)
    if table_dtype == "int8":
        return torch.round(ent_norm * 127.0).to(torch.int8)
    if table_dtype == "float32":
        return ent_norm
    raise ValueError(f"unknown table_dtype {table_dtype!r}")


def quantize_table(ent: torch.Tensor, table_dtype: str,
                   scale: bool) -> torch.Tensor:
    """Pre-normalize (cosine) and quantize candidate rows, as the
    reference's sharded path prepares them; float32 returns the raw
    table (normalized per dispatch there)."""
    if table_dtype == "float32":
        return ent
    if table_dtype == "int8" and not scale:
        raise ValueError(
            "table_dtype='int8' needs cosine scoring (normalized rows)")
    if scale:
        ent = ent / (torch.linalg.vector_norm(ent, dim=-1, keepdim=True)
                     + 1e-12)
    return quantize_rows(ent, table_dtype)
