"""Sampled dense-dense matmul, per-edge scores ``s_e = <x[src_e],
y[dst_e]>`` (counterpart of ``mpqe_tpu/ops/pallas_sddmm.py``): K7 as a
Hopper CUDA kernel, and the reference's plain formulations.

* K7 :func:`sddmm_kernel` (reference ``sddmm_pallas`` :48): ``[E]`` f32
  scores; an endpoint outside ``[0, N)`` scores 0.  As in the reference,
  ``round_up(N + 1, 8) > MAX_PALLAS_NODES`` raises ``ValueError`` (its
  TPU tiling arguments ``chunk`` and ``interpret`` have no counterpart).
  CUDA tensors launch ``csrc/sddmm.cu`` (built at first use), counted in
  ``sddmm_kernel.launches``; CPU tensors run the plain version
  :func:`sddmm_reference`, which sums each score's products over k
  ascending with one rounding per operation, as the kernel does: the two
  agree bit for bit on the card.  Forward only, like the reference
  kernel: a call in grad mode on an input that requires grad raises
  ``NotImplementedError``.
* :func:`sddmm_xla` (:96) and :func:`sddmm_relational_xla` (:107): the
  reference's composable oracles, in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from mpqe_tpu_torch.ops import cuda_build
from mpqe_tpu_torch.ops.cuda_build import refuse_grad
from mpqe_tpu_torch.ops.edge_store import round_up

MAX_PALLAS_NODES = 8192


def _endpoints(n: int, src: torch.Tensor, dst: torch.Tensor):
    """(clamped src, clamped dst, both endpoints in range)."""
    s, t = src.long(), dst.long()
    valid = (s >= 0) & (s < n) & (t >= 0) & (t < n)
    return s.clamp(0, n - 1), t.clamp(0, n - 1), valid


def sddmm_xla(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor) -> torch.Tensor:
    """Composable formulation (the reference's oracle and unbounded-size
    fallback)."""
    s, t, valid = _endpoints(x.shape[0], src, dst)
    return torch.sum(x[s] * y[t], dim=-1) * valid.to(x.dtype)


def sddmm_relational_xla(x: torch.Tensor, y: torch.Tensor,
                         w_rel: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, rel: torch.Tensor,
                         n_rels: int) -> torch.Tensor:
    """Relation-transformed edge scores ``x[src]^T W_rel y[dst]`` (the
    bilinear link-scoring form); a relation outside ``[0, n_rels)`` scores
    0, endpoints are clamped, as in the reference."""
    n = x.shape[0]
    w_e = w_rel[rel.long().clamp(0, n_rels - 1)]  # [E, d, d]
    ty = torch.einsum("eij,ej->ei", w_e, y[dst.long().clamp(0, n - 1)])
    xs = x[src.long().clamp(0, n - 1)]
    valid = ((rel >= 0) & (rel < n_rels)).to(x.dtype)
    return torch.sum(xs * ty, dim=-1) * valid


def sddmm_reference(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: per edge the f32 products ``x[src][k] *
    y[dst][k]``, summed over k ascending from 0, one rounding per
    operation; 0 where an endpoint is out of range."""
    s, t, valid = _endpoints(x.shape[0], src, dst)
    p = x.to(torch.float32)[s] * y.to(torch.float32)[t]
    acc = p.new_zeros(p.shape[0])
    for k in range(p.shape[1]):
        acc = acc + p[:, k]
    return torch.where(valid, acc, torch.zeros_like(acc))


_KERNEL = None


def _kernel():
    """The built K7 library, its entry point's argument types set."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("sddmm", ["sddmm.cu"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mpqe_sddmm.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, p, p]
        lib.mpqe_sddmm.restype = i
        _KERNEL = lib
    return _KERNEL


def sddmm_kernel(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor) -> torch.Tensor:
    """K7: per-edge dot products ``[E]`` f32 of ``x [N, d]`` and ``y [N,
    d]`` (pass ``x`` twice for symmetric scoring) over ``src``, ``dst``
    ``[E]``; out-of-range endpoints score 0.  CUDA tensors: the kernel,
    counted in ``sddmm_kernel.launches``; CPU tensors: the plain
    version."""
    refuse_grad("sddmm_kernel", x, y)
    if x.dim() != 2 or tuple(y.shape) != tuple(x.shape):
        raise ValueError(f"x and y must both be [N, d]; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if src.dim() != 1 or tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"src and dst must both be [E]; got "
                         f"{tuple(src.shape)} and {tuple(dst.shape)}")
    n, d = x.shape
    if round_up(n + 1, 8) > MAX_PALLAS_NODES:
        raise ValueError(f"{n} nodes exceeds the SDDMM kernel's cap "
                         f"({MAX_PALLAS_NODES}); use sddmm_xla")
    if n == 0 or d == 0:  # every score is an empty sum
        return torch.zeros(src.shape, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return sddmm_reference(x, y, src, dst)
    if x.device.type != "cuda":
        raise ValueError(f"sddmm_kernel: unsupported device {x.device}")
    dev = x.device
    for name, t in (("y", y), ("src", src), ("dst", dst)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    out = torch.empty((src.shape[0],), dtype=torch.float32, device=dev)
    if src.shape[0] == 0:
        return out
    xf = x.to(torch.float32).contiguous()
    yf = y.to(torch.float32).contiguous()
    s32 = src.to(torch.int32).contiguous()
    d32 = dst.to(torch.int32).contiguous()
    lib = _kernel()
    with torch.cuda.device(dev):
        err = lib.mpqe_sddmm(xf.data_ptr(), yf.data_ptr(), s32.data_ptr(),
                             d32.data_ptr(), n, d, src.shape[0],
                             out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7 kernel launch failed: cudaError {err}")
    sddmm_kernel.launches += 1
    return out


sddmm_kernel.launches = 0
