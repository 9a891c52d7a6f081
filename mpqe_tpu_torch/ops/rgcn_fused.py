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
for CPU tensors only.  Both versions take the same f32 operations in the
same order, one rounding each: ``W``'s terms b ascending, the product
over k ascending, then ``* norm``.  The kernel fuses the gather
``x[src]`` that the reference leaves to XLA.

:class:`EdgeMessages` is the reference's ``custom_vjp`` (:268-360): the
backward's ``dxs`` is the same kernel on ``g`` with the weights
transposed, the per-chunk ``dW = xs^T (g * norm)`` is one ``torch.bmm``
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
from mpqe_tpu_torch.ops import embed as embed_ops
from mpqe_tpu_torch.ops import segment as segment_ops
from mpqe_tpu_torch.ops.edge_store import EdgeStore

# basis tables above this size take the materialized per-relation route
# (the reference's VMEM budget rule, kept because the two routes round
# differently)
MAX_BASIS_VMEM_BYTES = 8 * 1024 * 1024

DEFAULT_CHUNK = 512
TARGET_BLOCKS = 264  # row splits until a launch has about 2 blocks per SM
ROW_TILE = 32  # the kernel's rows per pass (csrc/rgcn_fused.cu TR)
COL_TILE = 64  # the kernel's columns per block (CT)


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
    if src is None:
        return x
    return x[src.long().clamp(0, x.shape[0] - 1)]


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
    """Plain version of K5a: ``[E_pad, N]`` f32."""
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


def _kernel():
    """The built K5 library, its entry points' argument types set."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("rgcn_fused", ["rgcn_fused.cu"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mpqe_rgcn_msg_basis.argtypes = [p, i, p, p, i, p, p, i, i, i, i,
                                            i, p, p]
        lib.mpqe_rgcn_msg_basis.restype = i
        lib.mpqe_rgcn_msg_wrel.argtypes = [p, i, p, p, p, p, i, i, i, i, i,
                                           p, p]
        lib.mpqe_rgcn_msg_wrel.restype = i
        lib.mpqe_rgcn_msg_smem_bytes.argtypes = [i]
        lib.mpqe_rgcn_msg_smem_bytes.restype = ll
        lib.mpqe_rgcn_msg_max_smem.argtypes = [i]
        lib.mpqe_rgcn_msg_max_smem.restype = ll
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


def _prepare(x, src, w, norm, chunk: int):
    """Checks common to both kernels; returns (lib, out, n_chunks, split,
    K, N)."""
    dev = x.device
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError("x must be [rows, K] and the weights [*, K, N]")
    E = norm.shape[0]
    K, N = w.shape[1], w.shape[2]
    if chunk <= 0 or E % chunk:
        raise ValueError(f"{E} edges are not a whole number of chunks of "
                         f"{chunk}")
    _check("x", x, torch.float32, (x.shape[0], K), dev)
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
    with torch.cuda.device(dev):
        have = lib.mpqe_rgcn_msg_max_smem(torch.cuda.current_device())
    if lib.mpqe_rgcn_msg_smem_bytes(K) > have:
        raise ValueError(f"input width {K} needs more shared memory per "
                         f"block than the card's {have} bytes")
    n_chunks = E // chunk
    tiles = max(n_chunks * -(-N // COL_TILE), 1)
    split = max(1, min(-(-TARGET_BLOCKS // tiles), -(-chunk // ROW_TILE)))
    out = torch.empty((E, N), dtype=torch.float32, device=dev)
    return lib, out, n_chunks, split, K, N


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def messages_basis(x: torch.Tensor, src: Optional[torch.Tensor],
                   basis: torch.Tensor, chunk_coeff: torch.Tensor,
                   norm: torch.Tensor, chunk: int) -> torch.Tensor:
    """K5a: per-edge messages ``[E_pad, N]`` f32 of relation chunks with
    the pad-masked ``chunk_coeff [n_chunks, Bb]`` and ``basis [Bb, K,
    N]``; ``src`` ``[E_pad]`` int32 gathers the rows of ``x`` (``None``:
    ``x`` holds one row per edge).  CUDA tensors: the kernel, counted in
    ``messages_basis.launches``; CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return messages_basis_reference(x, src, basis, chunk_coeff, norm,
                                        chunk)
    if x.device.type != "cuda":
        raise ValueError(f"messages_basis: unsupported device {x.device}")
    lib, out, n_chunks, split, K, N = _prepare(x, src, basis, norm, chunk)
    bb = basis.shape[0]
    _check("chunk_coeff", chunk_coeff, torch.float32, (n_chunks, bb),
           x.device)
    with torch.cuda.device(x.device):
        err = lib.mpqe_rgcn_msg_basis(
            x.data_ptr(), x.shape[0], _ptr(src), basis.data_ptr(), bb,
            chunk_coeff.data_ptr(), norm.data_ptr(), n_chunks, chunk, split,
            K, N, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5a kernel launch failed: cudaError {err}")
    messages_basis.launches += 1
    return out


messages_basis.launches = 0


def messages_wrel(x: torch.Tensor, src: Optional[torch.Tensor],
                  w_rel: torch.Tensor, chunk_rel_clipped: torch.Tensor,
                  norm: torch.Tensor, chunk: int) -> torch.Tensor:
    """K5b: per-edge messages ``[E_pad, N]`` f32 through each chunk's
    ``w_rel [R, K, N]`` block (``chunk_rel_clipped [n_chunks]``, clamped
    into ``[0, R)`` here too).  CUDA tensors: the kernel, counted in
    ``messages_wrel.launches``; CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return messages_wrel_reference(x, src, w_rel, chunk_rel_clipped,
                                       norm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"messages_wrel: unsupported device {x.device}")
    lib, out, n_chunks, split, K, N = _prepare(x, src, w_rel, norm, chunk)
    if chunk_rel_clipped.device != x.device or \
            tuple(chunk_rel_clipped.shape) != (n_chunks,):
        raise ValueError(f"chunk_rel must be [{n_chunks}] on {x.device}")
    crel = chunk_rel_clipped.to(torch.int32).clamp(
        0, w_rel.shape[0] - 1).contiguous()
    with torch.cuda.device(x.device):
        err = lib.mpqe_rgcn_msg_wrel(
            x.data_ptr(), x.shape[0], _ptr(src), w_rel.data_ptr(),
            crel.data_ptr(), norm.data_ptr(), n_chunks, chunk, split, K, N,
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
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
    w_c = torch.einsum("cb,bio->cio", ce, basis)
    msg = torch.einsum("ced,cdo->ceo", xs.reshape(-1, chunk, x.shape[1]),
                       w_c)
    return msg.reshape(-1, basis.shape[-1]) * norm[:, None].float()


class EdgeMessages(torch.autograd.Function):
    """Per-edge messages ``[E_pad, d_out]`` through K5:
    ``apply(x, basis, coeff, src, norm, chunk_rel, n_rels, chunk)``.  For a
    full-weight layer pass ``coeff=None`` and ``w_rel [R, d_in, d_out]``
    as ``basis``.  Gradients reach ``x``, ``basis`` and ``coeff``."""

    @staticmethod
    def forward(ctx, x, basis, coeff, src, norm, chunk_rel, n_rels, chunk):
        ctx.meta = (n_rels, chunk)
        ctx.save_for_backward(x, basis, coeff, src, norm, chunk_rel)
        x = x.contiguous()
        if coeff is None:
            return messages_wrel(x, src, basis.contiguous(),
                                 chunk_rel.clamp(0, n_rels - 1), norm, chunk)
        ce = _masked_chunk_coeff(coeff, chunk_rel, n_rels).contiguous()
        return messages_basis(x, src, basis.contiguous(), ce, norm, chunk)

    @staticmethod
    def backward(ctx, g):
        n_rels, chunk = ctx.meta
        x, basis, coeff, src, norm, chunk_rel = ctx.saved_tensors
        n, d_in = x.shape
        src_cl = src.long().clamp(0, n - 1)
        g = g.to(torch.float32).contiguous()
        rel_cl = chunk_rel.long().clamp(0, n_rels - 1)
        w_t = basis.transpose(1, 2).contiguous()
        if coeff is None:
            dxs = messages_wrel(g, None, w_t, rel_cl.to(torch.int32), norm,
                                chunk)
        else:
            ce = _masked_chunk_coeff(coeff, chunk_rel, n_rels).contiguous()
            dxs = messages_basis(g, None, w_t, ce, norm, chunk)
        dx = embed_ops.scatter_add_dense(n, src_cl, dxs.to(x.dtype))
        xs_c = x[src_cl].reshape(-1, chunk, d_in)
        gn_c = (g * norm[:, None]).reshape(-1, chunk, g.shape[-1])
        dw_c = torch.bmm(xs_c.transpose(1, 2), gn_c)
        valid = (chunk_rel < n_rels).to(dw_c.dtype)
        if coeff is None:
            dw_rel = segment_ops.segment_sum(dw_c * valid[:, None, None],
                                             rel_cl, basis.shape[0])
            return dx, dw_rel.to(basis.dtype), None, None, None, None, \
                None, None
        dbasis = torch.einsum("cb,cdo->bdo", ce, dw_c)
        dcoeff_c = torch.einsum("cdo,bdo->cb", dw_c, basis)
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
    K5b, as the reference does; full-weight layers always take K5b."""
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
            w_rel = torch.einsum("rb,bio->rio", layer.coeff, layer.basis)
            msg = rgcn_edge_messages(x, w_rel, None, src, norm, n_rels,
                                     chunk, chunk_rel)
        else:
            msg = rgcn_edge_messages(x, layer.basis, layer.coeff, src, norm,
                                     n_rels, chunk, chunk_rel)
    else:
        msg = rgcn_edge_messages(x, layer.w_rel, None, src, norm, n_rels,
                                 chunk, chunk_rel)
    agg = segment_ops.segment_sum(msg, dst, n)
    return x @ layer.w_self + agg + layer.bias
