"""Relation-chunked fused R-GCN layer (counterpart of
``mpqe_tpu/ops/pallas_rgcn.py``): K5a and K5b as Hopper CUDA kernels.

The layer splits into (1) the per-edge messages ``msg_e = (x[src_e] @
W_{rel_e}) * norm_e`` over edges laid out in chunks that share one
relation (:func:`chunk_by_relation` for a general graph,
``ops/template_layout.py:template_chunked`` for a template batch), (2) a
segment sum into destinations and (3) the self-loop and bias.  (1) is the
kernel:

* K5a :func:`messages_basis` (reference ``_messages_pallas_basis`` :145):
  per chunk ``W = sum_b c_b V_b`` from the basis, then the product;
* K5b :func:`messages_wrel` (reference ``_messages_pallas_wrel`` :193):
  per chunk the relation's own ``W_rel`` block.

Each wrapper launches ``csrc/rgcn_fused.cu`` (built at first use) for
CUDA tensors, counted in its ``launches``, and runs its plain PyTorch
version (:func:`messages_basis_reference`, :func:`messages_wrel_reference`)
for CPU tensors only.  The plain versions take every f32 operation in one
order, one rounding each: ``W``'s terms b ascending, the product over k
ascending, then ``* norm``.  The kernel builds ``W`` and scales by
``norm`` the same way but takes the product on the tensor cores in split
TF32 (three TF32 products per f32 product, f32 sums in the tensor cores'
order), so it is held to gates, not to the plain bits: <= 1e-4 of the
plain version and <= 1e-5 of the f32 oracle :func:`_edge_messages_xla`
(``chip_smoke.py`` phase 4; ``tools/k5_probe.py emulate`` has the
emulated figures).  The kernel fuses the gather ``x[src]`` that the
reference leaves to XLA.  The rows of a bf16 model are gathered as bf16
(half the bytes) and widened in the kernel, whose products and sums are
then those of the f32 rows ``x.float()`` bit for bit (a bf16 value is
exact in TF32, so one of the three passes adds only zeros and is
skipped); the plain versions compute on ``x.float()``.

:class:`EdgeMessages` is the reference's ``custom_vjp`` (:268-360): the
backward's ``dxs`` is the same kernel on ``g``, reading the weights
transposed (``w_transposed``: no transposed copy), the per-chunk ``dW =
xs^T (g * norm)`` is one ``torch.bmm``
(the reference leaves it to XLA), ``dx`` goes through
``scatter_add_dense`` and ``dbasis`` / ``dcoeff`` / ``dw_rel`` follow by
einsums and a segment sum over chunk relations.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from mpqe_tpu_torch.ops import cuda_build
from mpqe_tpu_torch.ops import dtypes
from mpqe_tpu_torch.ops import embed as embed_ops
from mpqe_tpu_torch.ops import segment as segment_ops
from mpqe_tpu_torch.ops.edge_store import EdgeStore

# basis tables above this size take the materialized per-relation route
# (the reference's VMEM budget rule, kept because the two routes round
# differently)
MAX_BASIS_VMEM_BYTES = 8 * 1024 * 1024

DEFAULT_CHUNK = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def chunk_by_relation(store: EdgeStore,
                      chunk: int = DEFAULT_CHUNK) -> Dict[str, np.ndarray]:
    """Re-pad a relation-sorted EdgeStore so that every ``chunk`` edges
    share one relation: ``src``/``dst``/``norm`` ``[n_chunks * chunk]``
    and ``chunk_rel [n_chunks]`` (padding edges: ``src = dst = n_nodes``,
    ``norm = 0``; a graph without edges gets one padding chunk with
    ``chunk_rel = n_rels``)."""
    srcs, dsts, norms, crels = [], [], [], []
    pad_node = store.n_nodes
    for r in range(store.n_rels):
        lo, hi = int(store.rel_ptr[r]), int(store.rel_ptr[r + 1])
        k = hi - lo
        if k == 0:
            continue
        k_pad = _round_up(k, chunk)
        s = np.full(k_pad, pad_node, np.int32)
        d = np.full(k_pad, pad_node, np.int32)
        w = np.zeros(k_pad, np.float32)
        s[:k] = store.src[lo:hi]
        d[:k] = store.dst[lo:hi]
        w[:k] = store.norm[lo:hi]
        srcs.append(s)
        dsts.append(d)
        norms.append(w)
        crels.append(np.full(k_pad // chunk, r, np.int32))
    if not srcs:
        srcs = [np.full(chunk, pad_node, np.int32)]
        dsts = [np.full(chunk, pad_node, np.int32)]
        norms = [np.zeros(chunk, np.float32)]
        crels = [np.full(1, store.n_rels, np.int32)]
    return {"src": np.concatenate(srcs), "dst": np.concatenate(dsts),
            "norm": np.concatenate(norms),
            "chunk_rel": np.concatenate(crels), "chunk": chunk}


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------
def _gather_rows(x: torch.Tensor, src: Optional[torch.Tensor]):
    """The rows ``x[clamp(src)]`` (``x`` itself without ``src``) in f32:
    bf16 rows widen exactly, as the kernels widen them."""
    if src is not None:
        x = x[src.long().clamp(0, x.shape[0] - 1)]
    return x.to(torch.float32)


def _chunk_products(xs: torch.Tensor, w_c: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """``xs [E, K]`` times its chunk's ``w_c [n_chunks, K, N]``, summed
    over k ascending with one rounding per multiply and per add."""
    K = xs.shape[1]
    xs_c = xs.reshape(-1, chunk, K)
    y = xs.new_zeros((xs_c.shape[0], chunk, w_c.shape[2]))
    for k in range(K):
        y = y + xs_c[:, :, k:k + 1] * w_c[:, k:k + 1, :]
    return y.reshape(-1, w_c.shape[2])


def combine_basis(basis: torch.Tensor,
                  chunk_coeff: torch.Tensor) -> torch.Tensor:
    """Per chunk ``W = c_0 V_0 + c_1 V_1 + ...``, b ascending (K5a's W)."""
    w = chunk_coeff[:, 0, None, None] * basis[0]
    for b in range(1, basis.shape[0]):
        w = w + chunk_coeff[:, b, None, None] * basis[b]
    return w


def messages_basis_reference(x, src, basis, chunk_coeff, norm,
                             chunk: int) -> torch.Tensor:
    """Plain version of K5a: ``[E_pad, N]`` f32 (``x`` f32 or bf16, the
    weights and coefficients f32)."""
    xs = _gather_rows(x, src)
    y = _chunk_products(xs, combine_basis(basis, chunk_coeff), chunk)
    return y * norm[:, None]


def messages_wrel_reference(x, src, w_rel, chunk_rel_clipped, norm,
                            chunk: int) -> torch.Tensor:
    """Plain version of K5b: ``[E_pad, N]`` f32."""
    xs = _gather_rows(x, src)
    w = w_rel[chunk_rel_clipped.long().clamp(0, w_rel.shape[0] - 1)]
    return _chunk_products(xs, w, chunk) * norm[:, None]


# ----------------------------------------------------------------------
# The kernels
# ----------------------------------------------------------------------
_KERNEL = None
# K5a's combined weights, one buffer per (device, stream, shape): launches
# on one stream use it in turn
_SCRATCH: Dict[tuple, torch.Tensor] = {}


def _kernel():
    """The built K5 library, its entry points' argument types set."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("rgcn_fused", ["rgcn_fused.cu"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mpqe_rgcn_msg_basis.argtypes = [p, i, i, p, p, i, p, p, i, p, p,
                                            i, i, i, i, i, p, p]
        lib.mpqe_rgcn_msg_basis.restype = i
        lib.mpqe_rgcn_msg_wrel.argtypes = [p, i, i, p, p, i, p, p, i, i, i,
                                           i, i, p, p]
        lib.mpqe_rgcn_msg_wrel.restype = i
        lib.mpqe_rgcn_combine.argtypes = [p, i, p, p, i, i, i, i, p, p]
        lib.mpqe_rgcn_combine.restype = i
        lib.mpqe_rgcn_msg_live.argtypes = [p, i, p, p, i, p, p, p, i, i, i,
                                           i, p, p]
        lib.mpqe_rgcn_msg_live.restype = i
        _KERNEL = lib
    return _KERNEL


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(x, src, w, norm, chunk: int, w_transposed: bool):
    """Checks common to both kernels; returns (lib, out, n_chunks, K, N)."""
    dev = x.device
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError("x must be [rows, K] and the weights [*, K, N] "
                         "([*, N, K] with w_transposed)")
    E = norm.shape[0]
    if E >= 2 ** 31 or x.shape[0] >= 2 ** 31:
        raise ValueError(f"{E} edges or {x.shape[0]} rows exceed int32")
    K, N = (w.shape[2], w.shape[1]) if w_transposed else (w.shape[1],
                                                          w.shape[2])
    if chunk <= 0 or E % chunk:
        raise ValueError(f"{E} edges are not a whole number of chunks of "
                         f"{chunk}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.dtype, (x.shape[0], K), dev)
    _check("norm", norm, torch.float32, (E,), dev)
    _check("weights", w, torch.float32, w.shape, dev)
    if src is None:
        if x.shape[0] != E:
            raise ValueError("without src, x must have one row per edge")
    else:
        _check("src", src, torch.int32, (E,), dev)
    if x.shape[0] == 0:
        raise ValueError("x has no rows")
    lib = _kernel()
    out = torch.empty((E, N), dtype=torch.float32, device=dev)
    return lib, out, E // chunk, K, N


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _chunk_rel_on(chunk_rel: torch.Tensor, n_chunks: int,
                  dev) -> torch.Tensor:
    """``chunk_rel [n_chunks]`` as the kernel reads it: int32, contiguous
    (the kernel clamps it); no copy when it already is."""
    if chunk_rel.device != dev or tuple(chunk_rel.shape) != (n_chunks,):
        raise ValueError(f"chunk_rel must be [{n_chunks}] on {dev}")
    if chunk_rel.dtype == torch.int32 and chunk_rel.is_contiguous():
        return chunk_rel
    return chunk_rel.to(torch.int32).contiguous()


def messages_basis(x: torch.Tensor, src: Optional[torch.Tensor],
                   basis: torch.Tensor, coeff: torch.Tensor,
                   chunk_rel: torch.Tensor, n_rels: int,
                   norm: torch.Tensor, chunk: int,
                   w_transposed: bool = False) -> torch.Tensor:
    """K5a: per-edge messages ``[E_pad, N]`` f32 of relation chunks with
    ``basis [Bb, K, N]`` (``w_transposed``: ``basis [Bb, N, K]``, read as
    its transpose) and ``coeff [n_rels, Bb]``: chunk c takes the
    coefficients of relation ``chunk_rel[c]`` (clamped below at 0; ``>=
    n_rels``: a padding chunk, zero coefficients), as
    :func:`_masked_chunk_coeff` gives them.  ``src`` ``[E_pad]`` int32
    gathers the rows of ``x`` (``None``: ``x`` holds one row per edge),
    f32 or bf16 (read as they are: half the gather's bytes; the products
    are the f32 rows' on ``x.float()``, bit for bit); the weights, the
    coefficients and ``norm`` are f32.
    CUDA tensors: the kernel, counted in ``messages_basis.launches``; its
    prologue builds each relation's W once (and a zero W for padding) into
    a buffer of ``(n_rels + 1) K N`` floats kept per device and stream.
    CPU tensors: the plain version on the masked coefficients."""
    if x.device.type == "cpu":
        return messages_basis_reference(
            x, src, basis.transpose(1, 2) if w_transposed else basis,
            _masked_chunk_coeff(coeff, chunk_rel, n_rels), norm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"messages_basis: unsupported device {x.device}")
    lib, out, n_chunks, K, N = _prepare(x, src, basis, norm, chunk,
                                        w_transposed)
    bb = basis.shape[0]
    _check("coeff", coeff, torch.float32, (n_rels, bb), x.device)
    crel = _chunk_rel_on(chunk_rel, n_chunks, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shape = (n_rels + 1,) + tuple(basis.shape[1:])
    key = (x.device.index, stream, shape)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = torch.empty(shape, dtype=torch.float32,
                                              device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mpqe_rgcn_msg_basis(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0],
            _ptr(src), basis.data_ptr(), bb,
            coeff.data_ptr(), crel.data_ptr(), n_rels, scratch.data_ptr(),
            norm.data_ptr(), n_chunks, chunk, K, N, int(w_transposed),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K5a kernel launch failed: cudaError {err}")
    messages_basis.launches += 1
    return out


messages_basis.launches = 0


def messages_wrel(x: torch.Tensor, src: Optional[torch.Tensor],
                  w_rel: torch.Tensor, chunk_rel_clipped: torch.Tensor,
                  norm: torch.Tensor, chunk: int,
                  w_transposed: bool = False) -> torch.Tensor:
    """K5b: per-edge messages ``[E_pad, N]`` f32 through each chunk's
    ``w_rel [R, K, N]`` block (``w_transposed``: ``w_rel [R, N, K]``, read
    as its transpose; ``chunk_rel_clipped [n_chunks]``, clamped into ``[0,
    R)`` by the kernel too); ``x`` f32 or bf16, as for K5a.  CUDA tensors:
    the kernel, counted in
    ``messages_wrel.launches``; CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return messages_wrel_reference(
            x, src, w_rel.transpose(1, 2) if w_transposed else w_rel,
            chunk_rel_clipped, norm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"messages_wrel: unsupported device {x.device}")
    lib, out, n_chunks, K, N = _prepare(x, src, w_rel, norm, chunk,
                                        w_transposed)
    crel = _chunk_rel_on(chunk_rel_clipped, n_chunks, x.device)
    with torch.cuda.device(x.device):
        err = lib.mpqe_rgcn_msg_wrel(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0],
            _ptr(src), w_rel.data_ptr(),
            w_rel.shape[0], crel.data_ptr(), norm.data_ptr(), n_chunks,
            chunk, K, N, int(w_transposed), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5b kernel launch failed: cudaError {err}")
    messages_wrel.launches += 1
    return out


messages_wrel.launches = 0


# ----------------------------------------------------------------------
# Differentiable per-edge messages
# ----------------------------------------------------------------------
def _masked_chunk_coeff(coeff, chunk_rel, n_rels: int) -> torch.Tensor:
    rel_cl = chunk_rel.long().clamp(0, n_rels - 1)
    valid = (chunk_rel < n_rels).to(coeff.dtype)
    return coeff[rel_cl] * valid[:, None]


def _edge_messages_xla(x, basis, coeff, src, norm, chunk_rel, n_rels: int,
                       chunk: int) -> torch.Tensor:
    """The reference's oracle: per-chunk ``W`` materialized, then one
    batched product (``msg_e = (x[src_e] @ W_{rel_e}) * norm_e``)."""
    xs = _gather_rows(x, src)
    ce = _masked_chunk_coeff(coeff, chunk_rel, n_rels)
    w_c = dtypes.einsum_f32("cb,bio->cio", ce, basis)
    msg = torch.einsum("ced,cdo->ceo", xs.reshape(-1, chunk, x.shape[1]),
                       w_c)
    return msg.reshape(-1, basis.shape[-1]) * norm[:, None].float()


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` as contiguous f32 (no copy when it is)."""
    return None if t is None else t.to(torch.float32).contiguous()


class EdgeMessages(torch.autograd.Function):
    """Per-edge messages ``[E_pad, d_out]`` f32 through K5:
    ``apply(x, basis, coeff, src, norm, chunk_rel, n_rels, chunk)``.  For a
    full-weight layer pass ``coeff=None`` and ``w_rel [R, d_in, d_out]``
    as ``basis``.  Gradients reach ``x``, ``basis`` and ``coeff``.  At a
    bf16 model (the reference's ``_edge_messages_fwd`` / ``_bwd``): the
    kernels read the bf16 rows as they are and the weights taken up to
    f32; ``dx`` is scattered in ``x``'s dtype, ``dW`` and the leaves'
    gradients are f32 products of the bf16 values, rounded to the leaves'
    dtypes at the end."""

    @staticmethod
    def forward(ctx, x, basis, coeff, src, norm, chunk_rel, n_rels, chunk):
        ctx.meta = (n_rels, chunk)
        ctx.save_for_backward(x, basis, coeff, src, norm, chunk_rel)
        x = x.contiguous()
        if coeff is None:
            return messages_wrel(x, src, _f32(basis), chunk_rel, norm, chunk)
        return messages_basis(x, src, _f32(basis), _f32(coeff), chunk_rel,
                              n_rels, norm, chunk)

    @staticmethod
    def backward(ctx, g):
        n_rels, chunk = ctx.meta
        x, basis, coeff, src, norm, chunk_rel = ctx.saved_tensors
        n, d_in = x.shape
        src_cl = src.long().clamp(0, n - 1)
        g = g.to(torch.float32).contiguous()
        rel_cl = chunk_rel.long().clamp(0, n_rels - 1)
        w = _f32(basis)
        if coeff is None:
            dxs = messages_wrel(g, None, w, chunk_rel, norm, chunk,
                                w_transposed=True)
        else:
            dxs = messages_basis(g, None, w, _f32(coeff), chunk_rel, n_rels,
                                 norm, chunk, w_transposed=True)
        dx = embed_ops.scatter_add_dense(n, src_cl, dxs.to(x.dtype))
        xs_c = _gather_rows(x, src_cl).reshape(-1, chunk, d_in)
        gn_c = (g * norm[:, None]).reshape(-1, chunk, g.shape[-1])
        dw_c = torch.bmm(xs_c.transpose(1, 2), gn_c)
        valid = (chunk_rel < n_rels).to(dw_c.dtype)
        if coeff is None:
            dw_rel = segment_ops.segment_sum(dw_c * valid[:, None, None],
                                             rel_cl, basis.shape[0])
            return dx, dw_rel.to(basis.dtype), None, None, None, None, \
                None, None
        ce = _masked_chunk_coeff(coeff, chunk_rel, n_rels)
        dbasis = dtypes.einsum_f32("cb,cdo->bdo", ce, dw_c)
        dcoeff_c = dtypes.einsum_f32("cdo,bdo->cb", dw_c, basis)
        dcoeff = segment_ops.segment_sum(dcoeff_c * valid[:, None], rel_cl,
                                         coeff.shape[0])
        return (dx, dbasis.to(basis.dtype), dcoeff.to(coeff.dtype), None,
                None, None, None, None)


def rgcn_edge_messages(x, basis, coeff, src, norm, n_rels: int, chunk: int,
                       chunk_rel) -> torch.Tensor:
    """The reference's ``rgcn_edge_messages`` (its ``interpret`` flag has
    no counterpart): :class:`EdgeMessages`."""
    return EdgeMessages.apply(x, basis, coeff, src, norm, chunk_rel, n_rels,
                              chunk)


def _as_device(a, dev) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(dev)


def rgcn_sparse_fused(x: torch.Tensor, layer, chunked: Dict[str, object],
                      n_rels: int) -> torch.Tensor:
    """Full R-GCN layer: K5 messages + segment sum + self-loop + bias.

    ``chunked`` comes from :func:`chunk_by_relation` (numpy arrays, moved
    to ``x``'s device) or ``template_chunked`` (tensors).  A basis layer
    whose table exceeds :data:`MAX_BASIS_VMEM_BYTES` (the reference's
    rule, d padded to 128) materializes ``W_rel`` by an einsum and takes
    K5b, as the reference does; full-weight layers always take K5b.  The
    result is f32 whatever the leaves' dtype (the caller rounds)."""
    n = x.shape[0]
    dev = x.device
    src = _as_device(chunked["src"], dev).to(torch.int32)
    dst = _as_device(chunked["dst"], dev)
    norm = _as_device(chunked["norm"], dev).to(torch.float32)
    chunk_rel = _as_device(chunked["chunk_rel"], dev).to(torch.int32)
    chunk = int(chunked["chunk"])
    if layer.basis is not None:
        bb, d_in, d_out = layer.basis.shape
        vmem = bb * _round_up(d_in, 128) * _round_up(d_out, 128) * 4
        if vmem > MAX_BASIS_VMEM_BYTES:
            # rounded once to the leaves' dtype, as XLA's einsum rounds it
            w_rel = dtypes.einsum_f32("rb,bio->rio", layer.coeff,
                                      layer.basis).to(layer.basis.dtype)
            msg = rgcn_edge_messages(x, w_rel, None, src, norm, n_rels,
                                     chunk, chunk_rel)
        else:
            msg = rgcn_edge_messages(x, layer.basis, layer.coeff, src, norm,
                                     n_rels, chunk, chunk_rel)
    else:
        msg = rgcn_edge_messages(x, layer.w_rel, None, src, norm, n_rels,
                                 chunk, chunk_rel)
    agg = segment_ops.segment_sum(msg, dst, n)
    return dtypes.dot_f32(x, layer.w_self) + agg + layer.bias
