"""The fused TGT kernels K1, K2 and K3 as Hopper CUDA kernels.

Counterparts of ``mpqe_tpu/ops/pallas_fused_fwd.py``:

* K1 :func:`fused_tgt_forward` (reference :704, kernel ``_make_kernel``
  :158) and K2 :func:`fused_tgt_backward` (reference :569, kernel
  ``_make_bwd_kernel`` :473): the whole pruned TGT forward of a batch of
  one formula (shared relations) as one chain of products
  ``X_l @ W_l + b_l`` against per-layer block matrices that
  :func:`_layer_matrices` assembles from the parameters, and its reverse
  sweep.  Both run ``csrc/fused_tgt.cu``; see the section "K1 / K2"
  below.
* K3 :func:`fused_tgt_forward_multi` (reference :335, kernel
  ``_make_multi_kernel`` :230): one launch encodes a batch of queries of
  many formulas of one structure (per-query relations).  Basis-decomposed
  models only, forward only (serving and evaluation do not
  differentiate).  ``csrc/fused_multi.cu``.

K3 in three pieces, one function:

* :func:`prepare_fused_multi` builds the kernel's operands once per model
  (bf16 weight blocks laid out for the kernel, the f32 coefficient
  tables, and the layer-0 variable tables premultiplied in f32 and then
  rounded to bf16 — the reference's rounding points);
* :func:`fused_tgt_forward_multi_reference` is the plain PyTorch version
  of the kernel's function, with those rounding points;
* :func:`fused_tgt_forward_multi` is the wrapper: on CUDA tensors it
  launches ``csrc/fused_multi.cu`` (built at first use) or raises; on CPU
  tensors it runs the plain version.  ``fused_tgt_forward_multi.launches``
  counts kernel launches.

Both take the operands that :func:`prepare_fused_multi` built; ``model``
stays in their signatures for parity with the reference.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from mpqe_tpu_torch.ops import cuda_build
from mpqe_tpu_torch.queries import STRUCTURES

def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _plan(cfg, structure: str):
    from mpqe_tpu_torch.models import mpqe as mpqe_mod  # lazy: models imports ops

    spec = STRUCTURES[structure]
    steps = mpqe_mod.num_steps(cfg, structure)
    plan = mpqe_mod._live_slot_plan(spec, steps)
    anchors = set(spec.anchor_slots)
    in0 = plan[0][0]
    a_slots = tuple(s for s in in0 if s in anchors)
    v_slots = tuple(s for s in in0 if s not in anchors)
    return spec, steps, plan, a_slots, v_slots


def _var_layout(cfg, n_var: int, d_pad: int):
    """(packed, m8): packed=True when every variable slot's one-hot fits
    a disjoint ``m8``-wide column range of ONE d_pad-wide block."""
    m8 = _round_up(max(cfg.n_modes, 1), 8)
    return n_var * m8 <= d_pad, m8


def _check_model(cfg) -> None:
    if cfg.readout != "tgt":
        raise ValueError("fused_tgt_forward_multi requires readout='tgt'")
    if cfg.num_bases is None:
        raise ValueError(
            "fused_tgt_forward_multi requires basis decomposition "
            "(use encode_dense_multi for full-weight models)")


def _checked_plan(cfg, structure: str):
    """The plan, after the reference's own refusals (same messages)."""
    _check_model(cfg)
    spec, steps, plan, a_slots, v_slots = _plan(cfg, structure)
    d_pad = _round_up(cfg.embed_dim, 128)
    if cfg.n_modes > d_pad:
        raise ValueError("n_modes must fit the one-hot width (<= d_pad)")
    packed, _ = _var_layout(cfg, len(v_slots), d_pad)
    if not packed:
        raise ValueError("variable slots exceed the packed one-hot block")
    return spec, steps, plan, a_slots, v_slots


@dataclasses.dataclass
class FusedMultiOperands:
    """The kernel's operands for one model; build with
    :func:`prepare_fused_multi`.  Weight blocks are zero-padded to
    ``d_pad``; ``vw`` holds a layer's bases side by side, as the
    reference kernel's wide operand."""

    d: int
    d_pad: int
    n_modes: int
    n_rels: int
    n_bases: int
    ent: torch.Tensor  # [N, d] f32, the model's own table (not a copy)
    w_self: torch.Tensor  # [L, d_pad, d_pad] bf16 (k, n)
    bias: torch.Tensor  # [L, d_pad] f32
    vw: torch.Tensor  # [L, d_pad, Bb * d_pad] bf16 (k, b * d_pad + n)
    coeff: torch.Tensor  # [L, R, Bb] f32
    tself0: torch.Tensor  # [M, d_pad] bf16 = bf16(var @ w_self_0)
    tvar0: torch.Tensor  # [M, Bb, d_pad] bf16 = bf16(var @ basis_0[b])
    descs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def prepare_fused_multi(model, cfg) -> FusedMultiOperands:
    """Build K3's operands from the model's current parameters, on the
    model's device.  The f32 products ``var @ w_self_0`` and
    ``var @ basis_0[b]`` are taken before the bf16 rounding, as the
    reference kernel's operand assembly does (on the card, with TF32
    off)."""
    _check_model(cfg)
    f32, bf16 = torch.float32, torch.bfloat16
    d, dp, nb = cfg.embed_dim, _round_up(cfg.embed_dim, 128), cfg.num_bases
    layers = list(model.layers)
    L = len(layers)
    with torch.no_grad():
        def pad_last(x, n=2):
            return F.pad(x.to(f32), [0, dp - d] * n)

        basis = pad_last(torch.stack([lp.basis for lp in layers]))
        var = model.emb.var.to(f32)
        return FusedMultiOperands(
            d=d, d_pad=dp, n_modes=cfg.n_modes, n_rels=cfg.n_rels,
            n_bases=nb,
            ent=model.emb.ent.detach().to(f32).contiguous(),
            w_self=pad_last(torch.stack([lp.w_self for lp in layers]))
            .to(bf16).contiguous(),
            bias=pad_last(torch.stack([lp.bias for lp in layers]), 1)
            .contiguous(),
            # [L, Bb, k, n] -> [L, k, Bb * n]
            vw=basis.permute(0, 2, 1, 3).reshape(L, dp, nb * dp).to(bf16)
            .contiguous(),
            coeff=torch.stack([lp.coeff for lp in layers]).to(f32)
            .contiguous(),
            tself0=pad_last(var @ layers[0].w_self.to(f32), 1).to(bf16)
            .contiguous(),
            tvar0=pad_last(torch.einsum("md,bdo->mbo", var,
                                        layers[0].basis.to(f32)), 1)
            .to(bf16).contiguous(),
        )


def _rows_by_mode(table: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """``table[modes]`` in f32, with a zero row for an out-of-range mode
    (the reference selects these rows through a one-hot)."""
    n = table.shape[0]
    m = modes.long()
    ok = (m >= 0) & (m < n)
    rows = table[m.clamp(0, n - 1)].to(torch.float32)
    return torch.where(ok.view(-1, *([1] * (rows.dim() - 1))), rows,
                       rows.new_zeros(()))


def _ordered_matmul(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """``x[:, :d] @ w[:d]`` summed over k in ascending order with one f32
    rounding per step: the kernel's order.  Every product of two
    bf16-valued operands is exact in f32."""
    y = x.new_zeros((x.shape[0], w.shape[1]))
    for k in range(d):
        y = y + x[:, k:k + 1] * w[k]
    return y


def fused_tgt_forward_multi_reference(
    model,
    cfg,
    structure: str,
    node_entity: torch.Tensor,  # [B, n] int
    node_mode: torch.Tensor,  # [B, n] int
    edge_rel_q: torch.Tensor,  # [B, n_edges] int — PER-QUERY relations
    edge_norm_q: torch.Tensor,  # [B, n_edges] float32
    *,
    operands: FusedMultiOperands,
) -> torch.Tensor:
    """Plain PyTorch version of K3 → ``[B, d]`` f32.

    The rounding points are the Pallas kernel's: bf16 anchor rows,
    bf16 x bf16 products summed in f32, exact f32 coefficient selects,
    ``msg = (sum_b c_b h_b) * norm`` summed per destination in
    (source slot, edge) order, ``y = (self + bias) + msgs``,
    ``bf16(relu(y))`` between layers and f32 ``y`` after the last.
    Every sum runs in the CUDA kernel's order (k ascending, then bases
    ascending), so on the card the two agree bit for bit."""
    spec, steps, plan, a_slots, _ = _checked_plan(cfg, structure)
    ops = operands
    f32, bf16 = torch.float32, torch.bfloat16
    d, dp, nb = ops.d, ops.d_pad, ops.n_bases
    anchors = set(spec.anchor_slots)
    n_ent = ops.ent.shape[0]
    B = node_mode.shape[0]

    x = {}
    for s in a_slots:
        ids = node_entity[:, s].long().clamp(0, n_ent - 1)
        x[s] = F.pad(ops.ent[ids].to(bf16).to(f32), (0, dp - d))
    y: Dict[int, torch.Tensor] = {}
    for li, (_, out_slots, edges) in enumerate(plan):
        w = ops.w_self[li].to(f32)  # [k, n]
        vw = ops.vw[li].to(f32)  # [k, Bb * n]: one wide product per source
        y = {}
        for s in out_slots:
            if li == 0 and s not in anchors:
                self_term = _rows_by_mode(ops.tself0, node_mode[:, s])
            else:
                self_term = _ordered_matmul(x[s], w, d)
            y[s] = self_term + ops.bias[li]
        acc: Dict[int, torch.Tensor] = {}
        for s_src in sorted({spec.edge_src[j] for j in edges}):
            if li == 0 and s_src not in anchors:
                h = _rows_by_mode(ops.tvar0, node_mode[:, s_src])
            else:
                h = _ordered_matmul(x[s_src], vw, d).view(B, nb, dp)
            for j in edges:
                if spec.edge_src[j] != s_src:
                    continue
                r = edge_rel_q[:, j].long()
                ok = ((r >= 0) & (r < ops.n_rels))[:, None]
                ce = torch.where(
                    ok, ops.coeff[li][r.clamp(0, ops.n_rels - 1)],
                    ops.coeff.new_zeros(()))  # [B, Bb]
                msg = ce[:, 0:1] * h[:, 0]
                for b in range(1, nb):
                    msg = msg + ce[:, b:b + 1] * h[:, b]
                msg = msg * edge_norm_q[:, j:j + 1].to(f32)
                dst = spec.edge_dst[j]
                acc[dst] = msg if dst not in acc else acc[dst] + msg
        for s, m in acc.items():
            y[s] = y[s] + m
        if li < steps - 1:
            x = {s: torch.relu(y[s]).to(bf16).to(f32) for s in out_slots}
    return y[spec.target_slot][:, :d].contiguous()


def _descriptor(cfg, structure: str) -> List[int]:
    """The kernel's int32 plan (layout documented in the CUDA source)."""
    spec, steps, plan, a_slots, _ = _plan(cfg, structure)
    anchors = set(spec.anchor_slots)
    desc = [steps, len(a_slots), *a_slots,
            *(int(s in anchors) for s in range(spec.n_nodes))]
    for _, out_slots, edges in plan:
        desc += [len(out_slots), *out_slots]
        order = sorted(edges, key=lambda j: (spec.edge_src[j], j))
        desc.append(len(order))
        for j in order:
            desc += [spec.edge_src[j], spec.edge_dst[j], j]
    return desc


def _kernel():
    """The built library, its entry point's argument types set (cached)."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("fused_multi", ["fused_multi.cu"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mpqe_fused_multi_forward.argtypes = [
            p, i, p, ll, i, p, p, p, p, i, i, i, p, p, p, p, i, i, p, p, i,
            p, i, p]
        lib.mpqe_fused_multi_forward.restype = i
        lib.mpqe_fused_multi_smem_bytes.argtypes = [i, i]
        lib.mpqe_fused_multi_smem_bytes.restype = ll
        lib.mpqe_fused_multi_max_smem.argtypes = [i]
        lib.mpqe_fused_multi_max_smem.restype = ll
        _KERNEL = lib
    return _KERNEL


_KERNEL = None


def _check_cuda_inputs(ops: FusedMultiOperands, spec, tensors) -> None:
    ne, nm, erq, enq = tensors
    dev = ne.device
    B = ne.shape[0]
    want = {
        "node_entity": (ne, torch.int32, (B, spec.n_nodes)),
        "node_mode": (nm, torch.int32, (B, spec.n_nodes)),
        "edge_rel_q": (erq, torch.int32, (B, spec.n_edges)),
        "edge_norm_q": (enq, torch.float32, (B, spec.n_edges)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, node_entity on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for f in dataclasses.fields(ops):
        t = getattr(ops, f.name)
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError(f"operand {f.name} is on {t.device}, the "
                             f"inputs on {dev}")


def _device_plan(lib, ops: FusedMultiOperands, cfg, structure: str,
                 dev: torch.device) -> torch.Tensor:
    """The structure's descriptor on ``dev``, after checking that it and
    the padded width fit the kernel's limits on this card."""
    spec = STRUCTURES[structure]
    plan = _descriptor(cfg, structure)
    max_desc = lib.mpqe_fused_multi_max_desc()
    if len(plan) > max_desc:
        raise ValueError(f"{structure}: plan descriptor of {len(plan)} ints "
                         f"exceeds the kernel's {max_desc}")
    need = lib.mpqe_fused_multi_smem_bytes(spec.n_nodes, ops.d_pad)
    with torch.cuda.device(dev):
        have = lib.mpqe_fused_multi_max_smem(torch.cuda.current_device())
    if need > have:
        raise ValueError(
            f"{structure} at embed_dim={ops.d} needs {need} B of shared "
            f"memory per block; the card allows {have}")
    return torch.tensor(plan, dtype=torch.int32, device=dev)


def fused_tgt_forward_multi(
    model,
    cfg,
    structure: str,
    node_entity: torch.Tensor,  # [B, n] int32
    node_mode: torch.Tensor,  # [B, n] int32
    edge_rel_q: torch.Tensor,  # [B, n_edges] int32 — PER-QUERY relations
    edge_norm_q: torch.Tensor,  # [B, n_edges] float32
    *,
    operands: FusedMultiOperands,
) -> torch.Tensor:
    """Per-query-relation fused forward → ``[B, d]`` f32.

    CUDA tensors: one launch of the hand-written kernel on the current
    stream (inputs checked, nothing falls back).  CPU tensors: the plain
    version.  ``operands`` come from :func:`prepare_fused_multi`, built
    once per model."""
    spec, *_ = _checked_plan(cfg, structure)
    ops = operands
    args = (node_entity, node_mode, edge_rel_q, edge_norm_q)
    dev = node_entity.device
    if dev.type == "cpu":
        return fused_tgt_forward_multi_reference(
            model, cfg, structure, *args, operands=ops)
    if dev.type != "cuda":
        raise ValueError(f"fused_tgt_forward_multi: unsupported device {dev}")
    _check_cuda_inputs(ops, spec, args)
    B = node_entity.shape[0]
    out = torch.empty((B, ops.d), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _kernel()
    desc = ops.descs.get(structure)
    if desc is None:
        desc = ops.descs[structure] = _device_plan(lib, ops, cfg, structure,
                                                   dev)
    with torch.cuda.device(dev):
        err = lib.mpqe_fused_multi_forward(
            desc.data_ptr(), desc.numel(),
            ops.ent.data_ptr(), ops.ent.shape[0], ops.d,
            node_entity.data_ptr(), node_mode.data_ptr(),
            edge_rel_q.data_ptr(), edge_norm_q.data_ptr(),
            B, spec.n_nodes, spec.n_edges,
            ops.w_self.data_ptr(), ops.bias.data_ptr(),
            ops.vw.data_ptr(), ops.coeff.data_ptr(),
            ops.n_rels, ops.n_bases,
            ops.tself0.data_ptr(), ops.tvar0.data_ptr(), ops.n_modes,
            out.data_ptr(), ops.d_pad,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_multi kernel launch failed: cudaError {err}")
    fused_tgt_forward_multi.launches += 1
    return out


fused_tgt_forward_multi.launches = 0


# ----------------------------------------------------------------------
# K1 / K2: the shared-relation fused TGT forward and its backward
# ----------------------------------------------------------------------
#
# A batch of one formula shares its relations, so each pruned layer is
# ONE product ``Y_l = X_l @ W_l + b_l`` against a block matrix that
# :func:`_layer_matrices` assembles (f32, differentiable) from the
# parameters: self transforms on the diagonal blocks, per-edge relation
# transforms with ``edge_norm`` folded in, and the variable-mode table
# premultiplied into the layer-0 one-hot rows.  ``X_0`` is the layer-0
# operand (:func:`_layer0_operand`): bf16 anchor rows, one d_pad block
# per anchor slot, then the variable one-hot block(s); between layers
# ``X_{l+1} = bf16(relu(Y_l))``; the output is the first d columns of
# the last ``Y`` (the target slot's block).
#
# The kernels (``csrc/fused_tgt.cu``) and their plain versions here sum
# every f32 value in one fixed order, one rounding per step:
# * products over k ascending (``_ordered_matmul``), then ``+ bias``;
# * K2's ``dX = bf16(g) @ W^T`` over n ascending;
# * ``dW_l = X_l^T bf16(g_l)`` and ``db_l = sum_rows g_l`` per row
#   partition (:func:`_partition_rows`, fixed by B alone), rows
#   ascending, then the partitions' partial sums in partition order.
# A product of two bf16 values is exact in f32, so the kernels' fmaf
# equals the plain multiply-then-add and the two agree bit for bit.

PARTITION_MAX = 64  # dW partitions: at most this many, ...
PARTITION_MIN_ROWS = 16  # ... of at least this many rows


def _partition_rows(B: int) -> int:
    """Rows per ``dW`` partition for a batch of B rows (the last one may
    be shorter); depends on B only, never on the card."""
    return max(PARTITION_MIN_ROWS, -(-B // PARTITION_MAX))


def _checked_chain_plan(cfg, structure: str):
    """K1/K2's plan after the reference's refusals (same messages)."""
    if cfg.readout != "tgt":
        raise ValueError("fused_tgt_forward requires readout='tgt'")
    spec, steps, plan, a_slots, v_slots = _plan(cfg, structure)
    d_pad = _round_up(cfg.embed_dim, 128)
    if cfg.n_modes > d_pad:
        raise ValueError("n_modes must fit the one-hot width (<= d_pad)")
    return spec, steps, plan, a_slots, v_slots, d_pad


def _layer_matrices(model, cfg, spec, steps, plan, a_slots, v_slots,
                    edge_rel, edge_norm, d_pad):
    """Per-layer block weight matrix ``[k_l, n_l]`` and bias row
    ``[n_l]``, both f32 and differentiable in the parameters and
    ``edge_norm`` (the port's counterpart of the reference's ``jax.vjp``
    through this assembly).  Layer-0 rows: one d_pad block per anchor
    slot (``a_slots`` order), then the packed variable block (or one
    block per variable slot when packing does not fit); later layers
    follow the previous layer's out_slots.  The reference's bias is an
    ``[8, n_l]`` tile whose row 0 is this row.  Its ``fold_bias0``
    variant is not ported (ROADMAP Queue 1 item 2)."""
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops

    f32 = torch.float32
    d = cfg.embed_dim
    var = model.emb.var.to(f32)
    packed, m8 = _var_layout(cfg, len(v_slots), d_pad)
    n_a = len(a_slots)
    a_idx = {s: k for k, s in enumerate(a_slots)}
    v_idx = {s: k for k, s in enumerate(v_slots)}
    v0 = set(v_slots)

    def row0(s_in):
        if s_in in v0:
            if packed:
                return n_a * d_pad + v_idx[s_in] * m8
            return (n_a + v_idx[s_in]) * d_pad
        return a_idx[s_in] * d_pad

    k0 = (n_a + 1 if packed else n_a + len(v_slots)) * d_pad
    dev = model.emb.ent.device
    Ws, biases = [], []
    for li, (in_slots, out_slots, edges) in enumerate(plan):
        lp = model.layers[li]
        w_e = rgcn_ops._edge_weights(lp, edge_rel).to(f32)
        w_e = w_e * edge_norm.to(f32)[:, None, None]
        w_self = lp.w_self.to(f32)
        icol = {s: k for k, s in enumerate(in_slots)}
        ocol = {s: k for k, s in enumerate(out_slots)}
        k_l = k0 if li == 0 else len(in_slots) * d_pad
        W = torch.zeros((k_l, len(out_slots) * d_pad), dtype=f32, device=dev)

        def put(s_in, s_out, w):
            if li == 0 and s_in in v0:
                w = var @ w  # one-hot rows: select-then-matmul
            r = row0(s_in) if li == 0 else icol[s_in] * d_pad
            c = ocol[s_out] * d_pad
            W[r:r + w.shape[0], c:c + d] += w

        for s in out_slots:
            put(s, s, w_self)
        for j in edges:
            put(spec.edge_src[j], spec.edge_dst[j], w_e[j])
        Ws.append(W)
        bias = torch.zeros((len(out_slots) * d_pad,), dtype=f32, device=dev)
        for s in out_slots:
            bias[ocol[s] * d_pad:ocol[s] * d_pad + d] = lp.bias.to(f32)
        biases.append(bias)
    return Ws, biases


def _layer0_operand(cols, node_mode, v_slots, cfg, d_pad,
                    wire=torch.bfloat16) -> torch.Tensor:
    """``X_0 [B, k_0]`` in the wire type: the anchor rows (one d_pad
    block each, zero-padded), then the variable one-hot block(s).  The
    packed block sets column ``k * m8 + mode`` for the k-th variable
    slot, as the reference's in-kernel expansion does (its
    ``onehot_operand`` variant builds the same values outside)."""
    B = node_mode.shape[0]
    parts = [F.pad(c.to(wire), (0, d_pad - c.shape[1])) for c in cols]
    if v_slots:
        packed, m8 = _var_layout(cfg, len(v_slots), d_pad)
        iota = torch.arange(d_pad, device=node_mode.device)
        modes = node_mode[:, list(v_slots)].long()
        if packed:
            oh = torch.zeros((B, d_pad), dtype=torch.bool,
                             device=node_mode.device)
            for k in range(len(v_slots)):
                oh |= (modes[:, k:k + 1] + k * m8) == iota
            parts.append(oh.to(wire))
        else:
            parts += [(modes[:, k:k + 1] == iota).to(wire)
                      for k in range(len(v_slots))]
    return torch.cat(parts, dim=1).contiguous()


def _round_to(x: torch.Tensor, wire) -> torch.Tensor:
    return x.to(wire).to(torch.float32)


def _chain_forward_plain(x0, ws, bs, d: int) -> torch.Tensor:
    """Plain version of K1's kernel: ``[B, d]`` f32 from the layer-0
    operand, the wire-typed weights and the f32 bias rows."""
    wire = x0.dtype
    x = x0.to(torch.float32)
    L = len(ws)
    for li in range(L):
        y = _ordered_matmul(x, ws[li].to(torch.float32), x.shape[1]) + bs[li]
        if li < L - 1:
            x = _round_to(torch.relu(y), wire)
    return y[:, :d].contiguous()


def _partitioned_sums(x, gb, g, R: int):
    """``(x^T gb, sum_rows g)`` summed per R-row partition, rows
    ascending, then over the partitions in order (K2's reduction)."""
    B, k = x.shape
    n = gb.shape[1]
    P = max(-(-B // R), 1)
    pad = P * R - B
    xp = F.pad(x, (0, 0, 0, pad)).view(P, R, k)
    gbp = F.pad(gb, (0, 0, 0, pad)).view(P, R, n)
    gp = F.pad(g, (0, 0, 0, pad)).view(P, R, n)
    acc_w = x.new_zeros((P, k, n))
    acc_b = x.new_zeros((P, n))
    for r in range(R):
        acc_w = acc_w + xp[:, r, :, None] * gbp[:, r, None, :]
        acc_b = acc_b + gp[:, r]
    dw, db = x.new_zeros((k, n)), x.new_zeros((n,))
    for p in range(P):
        dw = dw + acc_w[p]
        db = db + acc_b[p]
    return dw, db


def _chain_backward_plain(x0, ws, bs, g, n_a: int, d: int, d_pad: int):
    """Plain version of K2's kernels → ``(dA [B, n_a, d], [dW_l],
    [db_l])``: recompute the chain, then per layer from the last
    ``dW_l = X_l^T bf16(g)``, ``db_l = sum_rows g``,
    ``g <- (bf16(g) @ W_l^T) * [Y_{l-1} > 0]``, and at layer 0 the anchor
    column blocks of ``bf16(g) @ W_0^T``.  With an f32 ``x0`` (the
    reference's ``f32_wire``, tests only) nothing rounds to bf16."""
    wire, f32 = x0.dtype, torch.float32
    B = x0.shape[0]
    L = len(ws)
    R = _partition_rows(B)
    xs, ys = [x0.to(f32)], []
    for li in range(L - 1):
        y = _ordered_matmul(xs[-1], ws[li].to(f32), xs[-1].shape[1]) + bs[li]
        ys.append(y)
        xs.append(_round_to(torch.relu(y), wire))
    gl = F.pad(g.to(f32), (0, ws[-1].shape[1] - d))
    dws, dbs = [None] * L, [None] * L
    da = None
    for li in range(L - 1, -1, -1):
        gb = _round_to(gl, wire)
        dws[li], dbs[li] = _partitioned_sums(xs[li], gb, gl, R)
        w = ws[li].to(f32)
        n_l = w.shape[1]
        if li > 0:
            dx = _ordered_matmul(gb, w.t(), n_l)
            gl = torch.where(ys[li - 1] > 0, dx, dx.new_zeros(()))
        else:
            dx = _ordered_matmul(gb, w[:n_a * d_pad].t(), n_l)
            da = dx.view(B, n_a, d_pad)[:, :, :d].contiguous()
    return da, dws, dbs


def _tgt_kernel():
    """The built K1/K2 library, argument types set (cached)."""
    global _TGT_KERNEL
    if _TGT_KERNEL is None:
        lib = cuda_build.load_library("fused_tgt", ["fused_tgt.cu"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mpqe_tgt_forward.argtypes = [p, i, i, p, p, p, p, p, i, p]
        lib.mpqe_tgt_forward.restype = i
        lib.mpqe_tgt_backward.argtypes = [
            p, i, i, p, p, p, p, p, p, i, i, i, p, p, p, i, i, p, p, p]
        lib.mpqe_tgt_backward.restype = i
        lib.mpqe_tgt_smem_bytes.argtypes = [i, i, p, p]
        lib.mpqe_tgt_smem_bytes.restype = ll
        lib.mpqe_tgt_max_smem.argtypes = [i]
        lib.mpqe_tgt_max_smem.restype = ll
        _TGT_KERNEL = lib
    return _TGT_KERNEL


_TGT_KERNEL = None
MAX_LAYERS = 8  # the CUDA source's MAXL


def _check_chain(x0, ws, bs, extra=()):
    """Device, type, shape and contiguity checks of a chain's operands on
    the card; returns (ks, ns)."""
    dev = x0.device
    wire = torch.bfloat16
    if x0.dtype != wire or x0.dim() != 2 or not x0.is_contiguous():
        raise ValueError("x0 must be a contiguous 2-D bfloat16 tensor")
    if not 0 < len(ws) == len(bs) <= MAX_LAYERS:
        raise ValueError(f"1 to {MAX_LAYERS} layers, one bias per layer")
    ks, ns = [], []
    for li, (w, b) in enumerate(zip(ws, bs)):
        k, n = w.shape
        want_k = x0.shape[1] if li == 0 else ns[-1]
        if (w.dtype != wire or w.dim() != 2 or not w.is_contiguous()
                or k != want_k or k % 128 or n % 128):
            raise ValueError(f"layer {li}: W must be a contiguous bfloat16 "
                             f"[{want_k}, n] with n a multiple of 128")
        if b.dtype != torch.float32 or tuple(b.shape) != (n,) or \
                not b.is_contiguous():
            raise ValueError(f"layer {li}: bias must be contiguous f32 [{n}]")
        ks.append(k)
        ns.append(n)
    for t in (*ws, *bs, *extra):
        if t.device != dev:
            raise ValueError(f"operand on {t.device}, x0 on {dev}")
    return ks, ns


def _ints(vals):
    return (ctypes.c_int * len(vals))(*vals)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_smem(lib, bwd: int, ks, ns, dev) -> None:
    """Raise unless one row tile's shared memory fits the card."""
    with torch.cuda.device(dev):
        have = lib.mpqe_tgt_max_smem(torch.cuda.current_device())
    if lib.mpqe_tgt_smem_bytes(bwd, len(ks), _ints(ks), _ints(ns)) > have:
        raise ValueError(f"layer widths {list(zip(ks, ns))} need more "
                         f"shared memory per block than the card's {have} "
                         f"bytes")


def _chain_forward(x0, ws, bs, d: int) -> torch.Tensor:
    """K1's kernel on CUDA tensors (checked, launched on the current
    stream, counted in ``fused_tgt_forward.launches``); the plain version
    on CPU tensors; any other device raises."""
    dev = x0.device
    if dev.type == "cpu":
        return _chain_forward_plain(x0, ws, bs, d)
    if dev.type != "cuda":
        raise ValueError(f"fused_tgt_forward: unsupported device {dev}")
    ks, ns = _check_chain(x0, ws, bs)
    if ns[-1] < d:
        raise ValueError(f"last layer has {ns[-1]} columns, fewer than d={d}")
    B = x0.shape[0]
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _tgt_kernel()
    _check_smem(lib, 0, ks, ns, dev)
    with torch.cuda.device(dev):
        err = lib.mpqe_tgt_forward(
            x0.data_ptr(), B, len(ws), _ints(ks), _ints(ns), _ptrs(ws),
            _ptrs(bs), out.data_ptr(), d,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tgt kernel launch failed: cudaError {err}")
    fused_tgt_forward.launches += 1
    return out


def _chain_backward(x0, ws, bs, g, n_a: int, d: int, d_pad: int):
    """K2's kernels on CUDA tensors (checked, launched on the current
    stream, counted in ``fused_tgt_backward.launches``); the plain
    version on CPU tensors; any other device raises.  Scratch (the
    recomputed activations, the per-layer cotangents and the partial
    sums of the row partitions) comes from ``torch.empty``."""
    dev = x0.device
    if dev.type == "cpu":
        return _chain_backward_plain(x0, ws, bs, g, n_a, d, d_pad)
    if dev.type != "cuda":
        raise ValueError(f"fused_tgt_backward: unsupported device {dev}")
    ks, ns = _check_chain(x0, ws, bs, (g,))
    B = x0.shape[0]
    if (g.dtype != torch.float32 or tuple(g.shape) != (B, d)
            or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous float32 [{B}, {d}]")
    if ns[-1] < d or n_a * d_pad > ks[0] or d_pad % 128:
        raise ValueError("anchor blocks or d do not fit the chain")
    f32 = torch.float32
    L = len(ws)
    da = torch.empty((B, n_a, d), dtype=f32, device=dev)
    sizes = [k * n + n for k, n in zip(ks, ns)]
    flat = torch.empty((sum(sizes),), dtype=f32, device=dev)
    dws, dbs, off = [], [], 0
    for k, n, s in zip(ks, ns, sizes):
        dws.append(flat[off:off + k * n].view(k, n))
        dbs.append(flat[off + k * n:off + s])
        off += s
    if B == 0:
        flat.zero_()
        return da, dws, dbs
    R = _partition_rows(B)
    P = -(-B // R)
    xg = [x0] + [torch.empty((B, k), dtype=torch.bfloat16, device=dev)
                 for k in ks[1:]]
    gg = [torch.empty((B, n), dtype=f32, device=dev) for n in ns]
    partial = torch.empty((P, sum(sizes)), dtype=f32, device=dev)
    wts = [w.t().contiguous() for w in ws]
    lib = _tgt_kernel()
    _check_smem(lib, 1, ks, ns, dev)
    with torch.cuda.device(dev):
        err = lib.mpqe_tgt_backward(
            x0.data_ptr(), B, L, _ints(ks), _ints(ns), _ptrs(ws),
            _ptrs(wts), _ptrs(bs), g.data_ptr(), d, d_pad, n_a,
            da.data_ptr(), _ptrs(xg), _ptrs(gg), R, P, partial.data_ptr(),
            flat.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_tgt backward launch failed: cudaError {err}")
    fused_tgt_backward.launches += 1
    return da, dws, dbs


def _anchor_cols(model, node_entity, a_slots, anchor_rows):
    """Per-anchor-slot ``[B, d]`` f32 rows (differentiable): gathered from
    ``emb.ent`` (ids clamped, as the reference's gather does) or taken
    from ``anchor_rows`` (``[B, A, d]`` or a sequence of ``[B, d]``)."""
    if anchor_rows is None:
        ent = model.emb.ent
        return [ent[node_entity[:, s].long().clamp(0, ent.shape[0] - 1)]
                .to(torch.float32) for s in a_slots]
    if isinstance(anchor_rows, (tuple, list)):
        return [c.to(torch.float32) for c in anchor_rows]
    return [anchor_rows[:, k, :].to(torch.float32)
            for k in range(len(a_slots))]


def _assemble(model, cfg, structure, node_entity, node_mode, edge_rel,
              edge_norm, anchor_rows):
    spec, steps, plan, a_slots, v_slots, d_pad = _checked_chain_plan(
        cfg, structure)
    cols = _anchor_cols(model, node_entity, a_slots, anchor_rows)
    Ws, biases = _layer_matrices(model, cfg, spec, steps, plan, a_slots,
                                 v_slots, edge_rel, edge_norm, d_pad)
    return v_slots, d_pad, cols, Ws, biases


class FusedChain(torch.autograd.Function):
    """K1 forward, K2 backward, over the assembled operands: ``apply(
    node_mode, layout, *cols, *Ws, *biases)`` with ``layout = (cfg,
    v_slots, d_pad, n_anchor_cols)``.  Gradients go to the anchor rows
    and to the f32 ``W_l`` / bias rows (the bf16 wire cast passes them
    straight through, as in the reference), so autograd carries them on
    through :func:`_layer_matrices` and the anchor gather."""

    @staticmethod
    def forward(ctx, node_mode, layout, *tensors):
        cfg, v_slots, d_pad, n_a = layout
        L = (len(tensors) - n_a) // 2
        cols, Ws, bs = tensors[:n_a], tensors[n_a:n_a + L], tensors[n_a + L:]
        x0 = _layer0_operand(cols, node_mode, v_slots, cfg, d_pad)
        ws = [W.to(torch.bfloat16).contiguous() for W in Ws]
        bs = [b.contiguous() for b in bs]
        ctx.save_for_backward(x0, *ws, *bs)
        ctx.meta = (n_a, L, cfg.embed_dim, d_pad)
        return _chain_forward(x0, ws, bs, cfg.embed_dim)

    @staticmethod
    def backward(ctx, g):
        n_a, L, d, d_pad = ctx.meta
        x0, *rest = ctx.saved_tensors
        ws, bs = rest[:L], rest[L:]
        da, dws, dbs = _chain_backward(
            x0, list(ws), list(bs), g.to(torch.float32).contiguous(), n_a,
            d, d_pad)
        return (None, None, *(da[:, k] for k in range(n_a)), *dws, *dbs)


def fused_tgt_forward(
    model,
    cfg,
    structure: str,
    node_entity: torch.Tensor,  # [B, n] int
    node_mode: torch.Tensor,  # [B, n] int
    edge_rel: torch.Tensor,  # [n_edges] int
    edge_norm: torch.Tensor,  # [n_edges] float32
    anchor_rows=None,  # None | [B, A, d] | sequence of [B, d]
) -> torch.Tensor:
    """Whole pruned TGT forward of one formula's batch → ``[B, d]`` f32.

    CUDA tensors: one launch of the hand-written kernel K1
    (``csrc/fused_tgt.cu``) on the current stream, counted in
    ``fused_tgt_forward.launches``; CPU tensors: its plain version.
    Differentiable through :func:`FusedChain` (K2 backward); the model's
    train path calls it through ``models.mpqe.encode_dense_fused``.

    The reference's ``block``, ``vmem_limit_mb``, ``onehot_operand`` and
    ``split_gemm`` tile the TPU or compute the same function another way
    and have no counterpart here (the one-hot block is always built
    outside the kernel, as ``onehot_operand`` does); ``out_bf16`` and
    ``fold_bias`` change the numbers and are not ported (ROADMAP Queue 1
    item 2)."""
    return _fused_apply(model, cfg, structure, node_entity, node_mode,
                        edge_rel, edge_norm, anchor_rows)


fused_tgt_forward.launches = 0


def _fused_apply(model, cfg, structure, node_entity, node_mode, edge_rel,
                 edge_norm, anchor_rows):
    """Differentiable K1 (K2 backward) from the model's parameters."""
    v_slots, d_pad, cols, Ws, bs = _assemble(
        model, cfg, structure, node_entity, node_mode, edge_rel, edge_norm,
        anchor_rows)
    return FusedChain.apply(node_mode, (cfg, tuple(v_slots), d_pad,
                                        len(cols)), *cols, *Ws, *bs)


def fused_tgt_forward_reference(model, cfg, structure, node_entity,
                                node_mode, edge_rel, edge_norm,
                                anchor_rows=None) -> torch.Tensor:
    """Plain PyTorch version of K1 (no gradient): the kernel's rounding
    points and summation order, on any device."""
    with torch.no_grad():
        v_slots, d_pad, cols, Ws, bs = _assemble(
            model, cfg, structure, node_entity, node_mode, edge_rel,
            edge_norm, anchor_rows)
        x0 = _layer0_operand(cols, node_mode, v_slots, cfg, d_pad)
        return _chain_forward_plain(x0, [W.to(torch.bfloat16) for W in Ws],
                                    bs, cfg.embed_dim)


def _backward_with(chain_bwd, model, cfg, structure, node_entity,
                   node_mode, edge_rel, edge_norm, anchor_rows, g, wire):
    """``(dparams, dedge_norm, danchor_rows)``: ``chain_bwd``'s dA, dW
    and db mapped back by autograd through the assembly."""
    params = dict(model.named_parameters())
    en = edge_norm.detach().to(torch.float32).requires_grad_()
    seq = isinstance(anchor_rows, (tuple, list))
    ar = None
    if anchor_rows is not None:
        ar = ([c.detach().requires_grad_() for c in anchor_rows] if seq
              else anchor_rows.detach().requires_grad_())
    with torch.enable_grad():
        v_slots, d_pad, cols, Ws, bs = _assemble(
            model, cfg, structure, node_entity, node_mode, edge_rel, en, ar)
    with torch.no_grad():
        x0 = _layer0_operand(cols, node_mode, v_slots, cfg, d_pad, wire)
        da, dws, dbs = chain_bwd(
            x0, [W.detach().to(wire).contiguous() for W in Ws],
            [b.detach().contiguous() for b in bs],
            g.to(torch.float32).contiguous(), len(cols), cfg.embed_dim,
            d_pad)
    leaves = list(params.values()) + [en] + (
        list(ar) if seq else ([ar] if ar is not None else []))
    grads = torch.autograd.grad(
        [*cols, *Ws, *bs], leaves,
        [*(da[:, k] for k in range(len(cols))), *dws, *dbs],
        allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr
             for t, gr in zip(leaves, grads)]
    dparams = dict(zip(params, grads[:len(params)]))
    dedge_norm = grads[len(params)]
    rest = grads[len(params) + 1:]
    danchor = None if anchor_rows is None else (
        type(anchor_rows)(rest) if seq else rest[0])
    return dparams, dedge_norm, danchor


def fused_tgt_backward(model, cfg, structure, node_entity, node_mode,
                       edge_rel, edge_norm, anchor_rows, g):
    """K2: the cotangents ``(dparams, dedge_norm, danchor_rows)`` of
    :func:`fused_tgt_forward` for the output cotangent ``g [B, d]``.
    ``dparams`` maps every ``model.named_parameters()`` name to its
    gradient (zeros where unused, as the reference's pytree);
    ``danchor_rows`` is ``None`` when the rows were gathered here (their
    gradient then reaches ``dparams["emb.ent"]``).  CUDA tensors run the
    hand-written kernels (counted in ``fused_tgt_backward.launches``),
    CPU tensors the plain version."""
    return _backward_with(_chain_backward, model, cfg, structure,
                          node_entity, node_mode, edge_rel, edge_norm,
                          anchor_rows, g, torch.bfloat16)


fused_tgt_backward.launches = 0


def fused_tgt_backward_reference(model, cfg, structure, node_entity,
                                 node_mode, edge_rel, edge_norm, anchor_rows,
                                 g, *, f32_wire: bool = False):
    """Plain PyTorch version of K2 on any device.  ``f32_wire`` drops
    every bf16 rounding (the reference's test-only option: it separates
    the structure of the reverse sweep from operand rounding)."""
    return _backward_with(_chain_backward_plain, model, cfg, structure,
                          node_entity, node_mode, edge_rel, edge_norm,
                          anchor_rows, g,
                          torch.float32 if f32_wire else torch.bfloat16)
