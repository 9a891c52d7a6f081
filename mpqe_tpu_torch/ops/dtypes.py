"""Model dtypes and the reference's rounding points at reduced precision.

A model's leaves are float32 or bfloat16 (``cfg.dtype``), as in the JAX
package.  Its products keep JAX's ``preferred_element_type=float32``:
bf16 operands, an f32 result.  ``torch.matmul`` of two bf16 tensors
returns bf16 (one rounding JAX does not have), and of an f32 and a bf16
tensor raises (JAX promotes the pair to f32), so the products here take
their operands up to f32, where every product of two bf16 values is
exact and only the order of the f32 sum differs from XLA's; on the card,
where ``torch.mm(..., out_dtype=torch.float32)`` exists, a product of two
bf16 matrices that needs no gradient takes the bf16 tensor cores with an
f32 result instead.  :func:`matmul` is a product without
``preferred_element_type``: JAX's promotion, no wider.
"""

from __future__ import annotations

import torch

MODEL_DTYPES = (torch.float32, torch.bfloat16)


def check_model_dtype(dtype) -> None:
    """``ValueError`` unless ``dtype`` is a model dtype of the port."""
    if dtype not in MODEL_DTYPES:
        raise ValueError(
            f"model dtype {dtype}: must be torch.float32 or torch.bfloat16")


def parse_dtype(name) -> torch.dtype:
    """The model dtype a ``model_config.json`` records: the port writes
    ``"torch.float32"`` / ``"torch.bfloat16"``, the JAX package
    ``"<class 'jax.numpy.float32'>"`` / ``"<class 'jax.numpy.bfloat16'>"``;
    the bare names ``"float32"`` / ``"bfloat16"`` (the CLIs' ``--dtype``)
    are read too."""
    s = str(name)
    if "bfloat16" in s:
        return torch.bfloat16
    if "float32" in s:
        return torch.float32
    raise ValueError(f"model dtype {name!r}: must be float32 or bfloat16")


def _mm_out_dtype_available() -> bool:
    return hasattr(torch.ops.aten.mm, "dtype")


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result (JAX's ``jnp.dot(a, b,
    preferred_element_type=float32)``).  f32 operands: the plain product.
    Otherwise, a bf16 operand beside an f32 one too, the operands go up to
    f32 (exact), except on the card for two bf16 matrices that need no
    gradient, which take ``torch.mm(a, b, out_dtype=torch.float32)`` where
    this torch has it."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if (a.is_cuda and a.dim() == 2 and b.dim() == 2
            and a.dtype == b.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))
            and _mm_out_dtype_available()):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with an f32 result from operands of any model
    dtype (taken up to f32 first, so every product is exact)."""
    return torch.einsum(eq, *(t.to(torch.float32) for t in operands))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion (``jnp.dot`` without
    ``preferred_element_type``): operands of one dtype multiply in it (two
    bf16 tensors give bf16, rounded once); an f32 and a bf16 operand give
    the f32 product of their f32 values (exact widening)."""
    if a.dtype == b.dtype:
        return a @ b
    return a.to(torch.float32) @ b.to(torch.float32)
