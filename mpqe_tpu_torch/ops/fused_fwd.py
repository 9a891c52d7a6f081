"""The fused TGT kernels K1, K2 and K3 as Hopper CUDA kernels.

Counterparts of ``mpqe_tpu/ops/pallas_fused_fwd.py``:

* K1 :func:`fused_tgt_forward` (reference :704, kernel ``_make_kernel``
  :158) and K2 :func:`fused_tgt_backward` (reference :569, kernel
  ``_make_bwd_kernel`` :473): the whole pruned TGT forward of a batch of
  one formula (shared relations) as one chain of products
  ``X_l @ W_l + b_l`` against per-layer block matrices that
  :func:`_layer_matrices` assembles from the parameters, and its reverse
  sweep.  Both run ``csrc/fused_tgt.cu``; see the section "K1 / K2"
  below.  K1 takes the reference's ``fold_bias`` and ``out_bf16``.
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
  launches ``csrc/fused_multi.cu`` (built at first use; one kernel launch
  per layer) or raises; on CPU tensors it runs the plain version.
  ``fused_tgt_forward_multi.launches`` counts its kernel launches on the
  card (one per layer).

The kernel takes its products on the tensor cores, so it is held to
:func:`multi_gate` against the plain version (K1's :func:`chain_gate` on
the output, and each layer against the plain layer from the kernel's own
inputs, :func:`fused_tgt_forward_multi_layers`; its controls,
:func:`multi_gate_controls`), not to 0.

All three take models whose leaves are float32 or bfloat16
(``cfg.dtype``): the operands are assembled from the leaves taken up to
f32, and a bf16 model's output is written in bf16 by the kernel itself
(K1's ``out_bf16`` store, K3's bf16 store), the reference's cast to
``cfg.dtype``.  K2 takes the bf16 cotangent up to f32.

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
    # [N, d] the model's own table (f32 or bf16, no copy), or its
    # row-sharded table (parallel/sharding.py), whose anchor rows each call
    # gathers into a compact table (:func:`_anchor_table`)
    ent: object
    w_self: torch.Tensor  # [L, d_pad, d_pad] bf16 (k, n)
    bias: torch.Tensor  # [L, d_pad] f32
    vw: torch.Tensor  # [L, d_pad, Bb * d_pad] bf16 (k, b * d_pad + n)
    coeff: torch.Tensor  # [L, R, Bb] f32
    tself0: torch.Tensor  # [M, d_pad] bf16 = bf16(var @ w_self_0)
    tvar0: torch.Tensor  # [M, Bb, d_pad] bf16 = bf16(var @ basis_0[b])
    # per structure: the kernel's plan (the descriptor parsed by the
    # library), checked against this card's shared memory at first use
    descs: Dict[str, object] = dataclasses.field(default_factory=dict)


def prepare_fused_multi(model, cfg) -> FusedMultiOperands:
    """Build K3's operands from the model's current parameters (f32 or
    bf16 leaves), on the model's device.  The f32 products ``var @
    w_self_0`` and ``var @ basis_0[b]`` are taken before the bf16
    rounding, as the reference kernel's operand assembly does (on the
    card, with TF32 off).  The entity table is the model's own, in its
    own dtype: the kernel gathers f32 or bf16 rows."""
    from mpqe_tpu_torch.models import embeddings as emb_mod

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
            ent=emb_mod.table_operand(model.emb.ent),
            w_self=pad_last(torch.stack([lp.w_self for lp in layers]))
            .to(bf16).contiguous(),
            bias=pad_last(torch.stack([lp.bias for lp in layers]), 1)
            .contiguous(),
            # [L, Bb, k, n] -> [L, k, Bb * n]
            vw=basis.permute(0, 2, 1, 3).reshape(L, dp, nb * dp).to(bf16)
            .contiguous(),
            coeff=torch.stack([_whole(lp.coeff, var.device)
                               for lp in layers]).to(f32).contiguous(),
            tself0=pad_last(var @ layers[0].w_self.to(f32), 1).to(bf16)
            .contiguous(),
            tvar0=pad_last(torch.einsum("md,bdo->mbo", var,
                                        layers[0].basis.to(f32)), 1)
            .to(bf16).contiguous(),
        )


def _whole(table, device) -> torch.Tensor:
    """A small table (a layer's ``[R, Bb]`` coeff) whole on ``device``: a
    parameter as it is, a row-sharded one (``shard_relations``) gathered
    from its owner blocks."""
    if isinstance(table, torch.Tensor):
        return table
    return table.rows(torch.arange(table.shape[0], device=device))


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


def _reordered_matmul(x: torch.Tensor, w: torch.Tensor,
                      d: int) -> torch.Tensor:
    """``x[:, :d] @ w[:d]`` summed exactly (float64) and rounded once:
    the same exact products as :func:`_ordered_matmul` in another sum
    order, the stand-in for the tensor cores' order in the derivation of
    :func:`chain_gate` (``tools/tgt_probe.py emulate``, the tests)."""
    return (x[:, :d].double() @ w[:d].double()).float()


def _multi_anchor_rows(ops, node_entity, a_slots) -> Dict[int, torch.Tensor]:
    """Layer 0's product rows: bf16 anchor rows (ids clamped, as the
    reference's gather), in f32, zero-padded to ``d_pad``."""
    n_ent = ops.ent.shape[0]
    x = {}
    for s in a_slots:
        ids = node_entity[:, s].long().clamp(0, n_ent - 1)
        x[s] = F.pad(ops.ent[ids].to(torch.bfloat16).to(torch.float32),
                     (0, ops.d_pad - ops.d))
    return x


def _multi_layer_plain(ops, spec, plan, li, x, node_mode, edge_rel_q,
                       edge_norm_q, mm) -> Dict[int, torch.Tensor]:
    """Layer ``li`` of the plain K3 from its product rows ``x`` (slot ->
    ``[B, d_pad]`` f32 holding bf16 values): ``y`` per output slot,
    ``[B, d_pad]`` f32, before any ReLU or rounding."""
    f32 = torch.float32
    d, dp, nb = ops.d, ops.d_pad, ops.n_bases
    anchors = set(spec.anchor_slots)
    B = node_mode.shape[0]
    _, out_slots, edges = plan[li]
    w = ops.w_self[li].to(f32)  # [k, n]
    vw = ops.vw[li].to(f32)  # [k, Bb * n]: one wide product per source
    y = {}
    for s in out_slots:
        if li == 0 and s not in anchors:
            self_term = _rows_by_mode(ops.tself0, node_mode[:, s])
        else:
            self_term = mm(x[s], w, d)
        y[s] = self_term + ops.bias[li]
    acc: Dict[int, torch.Tensor] = {}
    for s_src in sorted({spec.edge_src[j] for j in edges}):
        if li == 0 and s_src not in anchors:
            h = _rows_by_mode(ops.tvar0, node_mode[:, s_src])
        else:
            h = mm(x[s_src], vw, d).view(B, nb, dp)
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
    return y


def _multi_forward_plain(cfg, structure, node_entity, node_mode, edge_rel_q,
                         edge_norm_q, ops, mm):
    """The plain K3 → ``(out [B, d], acts)``; ``acts[l][s]`` is the
    ``[B, d_pad]`` input row of slot s to layer l (``bf16(relu(y))`` of
    layer l - 1, in f32) for every layer l >= 1."""
    spec, steps, plan, a_slots, _ = _checked_plan(cfg, structure)
    x = _multi_anchor_rows(ops, node_entity, a_slots)
    acts: Dict[int, Dict[int, torch.Tensor]] = {}
    for li in range(steps):
        y = _multi_layer_plain(ops, spec, plan, li, x, node_mode, edge_rel_q,
                               edge_norm_q, mm)
        if li < steps - 1:
            x = acts[li + 1] = {s: torch.relu(v).to(torch.bfloat16).to(
                torch.float32) for s, v in y.items()}
    return y[spec.target_slot][:, :ops.d].contiguous(), acts


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
    mm=None,
) -> torch.Tensor:
    """Plain PyTorch version of K3 → ``[B, d]`` in ``cfg.dtype``.

    The rounding points are the Pallas kernel's: bf16 anchor rows,
    bf16 x bf16 products summed in f32, exact f32 coefficient selects,
    ``msg = (sum_b c_b h_b) * norm`` (bases ascending, one rounding per
    operation) summed per destination in (source slot, edge) order,
    ``y = (self + bias) + msgs``, ``bf16(relu(y))`` between layers and
    ``y`` after the last, rounded once to ``cfg.dtype`` (f32: as it is;
    bf16: to nearest even, the kernel's bf16 store).  ``mm(x, w, k)`` takes the products
    (:func:`_ordered_matmul`, k ascending, unless given: the reordering
    emulation of ``tools/k3_probe.py`` passes another); every other sum
    runs in the CUDA kernel's order."""
    return _multi_forward_plain(cfg, structure, node_entity, node_mode,
                                edge_rel_q, edge_norm_q, operands,
                                mm or _ordered_matmul)[0].to(cfg.dtype)


def _descriptor(cfg, structure: str) -> List[int]:
    """The kernel's int32 plan: ``[steps]``, then per layer
    ``n_a, a_slot * n_a`` (the slots whose rows the layer multiplies),
    ``n_sp, sp * n_sp`` (message sources that are products, as indices
    into a_slot), ``n_ss, ss * n_ss`` (self terms that are products, the
    same), ``n_out, (slot, self) * n_out`` (self: index into ss, or -1
    for a layer-0 variable slot's premultiplied row), ``n_e, (sp, out,
    j, slot) * n_e`` (each edge in (source slot, edge id) order: its
    source as an index into sp, or -1 for a layer-0 variable source; its
    destination as an index into the out list; its id; its source
    slot).  Parsed by ``csrc/fused_multi.cu`` ``parse``."""
    spec, steps, plan, _, _ = _plan(cfg, structure)
    anchors = set(spec.anchor_slots)
    desc = [steps]
    for li, (_, out_slots, edges) in enumerate(plan):
        def product(s):
            return li > 0 or s in anchors
        order = sorted(edges, key=lambda j: (spec.edge_src[j], j))
        sp = [s for s in sorted({spec.edge_src[j] for j in edges})
              if product(s)]
        ss = [s for s in out_slots if product(s)]
        a = sorted(set(sp) | set(ss))
        desc += [len(a), *a, len(sp), *(a.index(s) for s in sp),
                 len(ss), *(a.index(s) for s in ss), len(out_slots)]
        for s in out_slots:
            desc += [s, ss.index(s) if s in ss else -1]
        desc.append(len(order))
        for j in order:
            s = spec.edge_src[j]
            desc += [sp.index(s) if s in sp else -1,
                     list(out_slots).index(spec.edge_dst[j]), j, s]
    return desc


def _kernel():
    """The built library, its entry points' argument types set (cached)."""
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.load_library("fused_multi", ["fused_multi.cu"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mpqe_fused_multi_plan.argtypes = [p, i, i, i, i, i]
        lib.mpqe_fused_multi_plan.restype = p
        lib.mpqe_fused_multi_plan_free.argtypes = [p]
        lib.mpqe_fused_multi_plan_free.restype = None
        lib.mpqe_fused_multi_plan_smem.argtypes = [p]
        lib.mpqe_fused_multi_plan_smem.restype = ll
        lib.mpqe_fused_multi_blocks.argtypes = [i, i]
        lib.mpqe_fused_multi_blocks.restype = ll
        lib.mpqe_fused_multi_max_smem.argtypes = [i]
        lib.mpqe_fused_multi_max_smem.restype = ll
        lib.mpqe_fused_multi_forward.argtypes = [
            p, p, i, ll, i, p, p, p, p, i, p, p, p, p, i, p, p, i, p, i, p,
            i, p]
        lib.mpqe_fused_multi_forward.restype = i
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
    if ops.ent.dtype not in (torch.float32, torch.bfloat16) or \
            not ops.ent.is_contiguous():
        raise ValueError("operand ent must be a contiguous float32 or "
                         f"bfloat16 table, got {ops.ent.dtype}")
    for f in dataclasses.fields(ops):
        t = getattr(ops, f.name)
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError(f"operand {f.name} is on {t.device}, the "
                             f"inputs on {dev}")


def multi_blocks(B: int, d_pad: int) -> int:
    """Blocks in each of the card's K3 launches (one launch per layer),
    as the library's grid has them."""
    return int(_kernel().mpqe_fused_multi_blocks(B, d_pad))


class _Plan:
    """A structure's descriptor parsed by the library once, at one padded
    width (``mpqe_fused_multi_plan``), freed with its operands."""

    def __init__(self, lib, handle: int):
        self.lib, self.handle = lib, handle

    def __del__(self):
        self.lib.mpqe_fused_multi_plan_free(self.handle)


def _device_plan(lib, ops: FusedMultiOperands, cfg, structure: str,
                 dev: torch.device) -> _Plan:
    """The structure's parsed plan, after checking that the kernel takes
    it and that its widest layer fits this card's shared memory at the
    padded width."""
    spec = STRUCTURES[structure]
    desc = _descriptor(cfg, structure)
    handle = lib.mpqe_fused_multi_plan(
        (ctypes.c_int * len(desc))(*desc), len(desc), spec.n_nodes,
        spec.n_edges, ops.n_bases, ops.d_pad)
    if not handle:
        raise ValueError(f"{structure}: the plan exceeds the kernel's "
                         f"limits (slots, edges or layers)")
    plan = _Plan(lib, handle)
    need = lib.mpqe_fused_multi_plan_smem(handle)
    with torch.cuda.device(dev):
        have = lib.mpqe_fused_multi_max_smem(torch.cuda.current_device())
    if need > have:
        raise ValueError(
            f"{structure} at embed_dim={ops.d} needs {need} B of shared "
            f"memory per block; the card allows {have}")
    return plan


def _launch(cfg, structure, args, ops, keep: bool,
            out_dtype=torch.float32):
    """Launch K3 on the current stream → ``(out, scratch)``: one launch a
    layer, each counted in ``fused_tgt_forward_multi.launches``, the
    output written in ``out_dtype`` (f32, or bf16 by the kernel's bf16
    store).  The
    activations between layers go through a bf16 scratch ``[planes]
    [slot][B][d_pad]`` from ``torch.empty`` (stream-ordered, so no two
    calls share one): two planes the layers take in turns, or with
    ``keep`` one plane a layer, so that every layer's activations are
    there after the call."""
    spec, steps, *_ = _checked_plan(cfg, structure)
    _check_cuda_inputs(ops, spec, args)
    node_entity, node_mode, edge_rel_q, edge_norm_q = args
    dev = node_entity.device
    B = node_entity.shape[0]
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K3 writes float32 or bfloat16, not {out_dtype}")
    out = torch.empty((B, ops.d), dtype=out_dtype, device=dev)
    planes = steps - 1 if keep else min(2, steps - 1)
    plane = spec.n_nodes * B * ops.d_pad
    stream = torch.cuda.current_stream(dev)
    scratch = torch.empty(planes * plane, dtype=torch.bfloat16, device=dev)
    if B == 0:
        return out, scratch.view(planes, spec.n_nodes, B, ops.d_pad)
    lib = _kernel()
    plan = ops.descs.get(structure)
    if plan is None:
        plan = ops.descs[structure] = _device_plan(lib, ops, cfg, structure,
                                                   dev)
    with torch.cuda.device(dev):
        err = lib.mpqe_fused_multi_forward(
            plan.handle, ops.ent.data_ptr(),
            int(ops.ent.dtype == torch.bfloat16), ops.ent.shape[0], ops.d,
            node_entity.data_ptr(), node_mode.data_ptr(),
            edge_rel_q.data_ptr(), edge_norm_q.data_ptr(), B,
            ops.w_self.data_ptr(), ops.bias.data_ptr(), ops.vw.data_ptr(),
            ops.coeff.data_ptr(), ops.n_rels, ops.tself0.data_ptr(),
            ops.tvar0.data_ptr(), ops.n_modes,
            scratch.data_ptr() if planes else None, planes,
            out.data_ptr(), int(out_dtype == torch.bfloat16),
            stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_multi kernel launch failed: cudaError {err}")
    fused_tgt_forward_multi.launches += steps
    return out, scratch.view(planes, spec.n_nodes, B, ops.d_pad)


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
    """Per-query-relation fused forward → ``[B, d]`` in ``cfg.dtype``
    (float32 or bfloat16; the kernel writes either, bf16 through its
    bf16 store).

    CUDA tensors: the hand-written kernel on the current stream (inputs
    checked, nothing falls back), one launch per layer, each counted
    once, with the activations between layers in a bf16 scratch.  CPU
    tensors: the plain version.  ``operands`` come from
    :func:`prepare_fused_multi`, built once per model."""
    operands, node_entity = _anchor_table(cfg, structure, operands,
                                          node_entity)
    args = (node_entity, node_mode, edge_rel_q, edge_norm_q)
    dev = node_entity.device
    if dev.type == "cpu":
        return fused_tgt_forward_multi_reference(
            model, cfg, structure, *args, operands=operands)
    if dev.type != "cuda":
        raise ValueError(f"fused_tgt_forward_multi: unsupported device {dev}")
    return _launch(cfg, structure, args, operands, keep=False,
                   out_dtype=cfg.dtype)[0]


fused_tgt_forward_multi.launches = 0


def _anchor_table(cfg, structure: str, ops: FusedMultiOperands,
                  node_entity: torch.Tensor):
    """``(ops, node_entity)`` as one call of K3 takes them: as they are
    for a table on one device; for a row-sharded table, the call's anchor
    rows gathered from their owner blocks onto ``node_entity``'s device
    into a compact ``[B * n_anchors, d]`` table, the anchor slots
    renumbered into it (the kernel reads the same rows, so it computes the
    same bits, in one launch a layer)."""
    if isinstance(ops.ent, torch.Tensor):
        return ops, node_entity
    a_slots = _checked_plan(cfg, structure)[3]
    table, node_entity = ops.ent.compact(node_entity, a_slots)
    return dataclasses.replace(ops, ent=table), node_entity


def fused_tgt_forward_multi_layers(model, cfg, structure: str, node_entity,
                                   node_mode, edge_rel_q, edge_norm_q, *,
                                   operands: FusedMultiOperands, mm=None):
    """K3 with every layer's activations kept → ``(out, acts)`` for
    :func:`multi_gate`, ``out`` in f32 whatever ``cfg.dtype`` (the gate's
    figures; a bf16 model's output is its rounding): ``acts[l][s]`` is the ``[B, d_pad]`` input row of
    slot s to layer l >= 1 (bf16 on the card, bf16 values in f32 on the
    CPU).  CUDA tensors: the kernel (launches counted as in
    :func:`fused_tgt_forward_multi`); CPU tensors: the plain version, its
    products by ``mm`` (the reordering emulation passes
    :func:`_reordered_matmul`)."""
    operands, node_entity = _anchor_table(cfg, structure, operands,
                                          node_entity)
    args = (node_entity, node_mode, edge_rel_q, edge_norm_q)
    dev = node_entity.device
    if dev.type == "cpu":
        return _multi_forward_plain(cfg, structure, *args, operands,
                                    mm or _ordered_matmul)
    if dev.type != "cuda":
        raise ValueError(f"fused_tgt_forward_multi: unsupported device {dev}")
    _, _, plan, _, _ = _checked_plan(cfg, structure)
    out, scratch = _launch(cfg, structure, args, operands, keep=True)
    acts = {li + 1: {s: scratch[li, s] for s in plan[li][1]}
            for li in range(len(plan) - 1)}
    return out, acts


def multi_gate_controls(cfg, structure: str, ops: FusedMultiOperands,
                        node_entity: torch.Tensor, edge_rel_q: torch.Tensor,
                        q: int = 0):
    """The two negative controls of :func:`multi_gate` as ``(name,
    operands, node_entity, edge_rel_q)``: the plain version fed these
    must fail the gate against the kernel.  Both change query ``q`` (0,
    an ordinary query) alone: ``relation``, its relation on the first
    edge of the last layer replaced by the next one (the per-query
    relation path that only K3 has); ``anchor_row``, its first anchor row
    moved 8 bf16 steps up (3 % of each element), through a copy of the
    entity table with that row appended."""
    _, _, plan, a_slots, _ = _plan(cfg, structure)
    j = plan[-1][2][0]
    er = edge_rel_q.clone()
    er[q, j] = (er[q, j].long() + 1) % ops.n_rels
    a = a_slots[0]
    n = ops.ent.shape[0]
    row = ops.ent[node_entity[q, a].long().clamp(0, n - 1)].to(torch.bfloat16)
    moved = (row.view(torch.int16) + 8).view(torch.bfloat16).to(ops.ent.dtype)
    ne = node_entity.clone()
    ne[q, a] = n
    moved_ops = dataclasses.replace(
        ops, ent=torch.cat([ops.ent, moved[None]]), descs={})
    return (("relation", ops, node_entity, er),
            ("anchor_row", moved_ops, ne, edge_rel_q))


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
# The plain versions here sum every f32 value in one fixed order, one
# rounding per step:
# * products over k ascending (``_ordered_matmul``), then ``+ bias``;
# * K2's ``dX = bf16(g) @ W^T`` over n ascending;
# * ``dW_l = X_l^T bf16(g_l)`` and ``db_l = sum_rows g_l`` per row
#   partition (:func:`_partition_rows`, fixed by B alone), rows
#   ascending, then the partitions' partial sums in partition order.
# The kernels (``csrc/fused_tgt.cu``) take the K-deep sums inside the
# products on the tensor cores, in the hardware's order, and multiply
# only the blocks of W_l that :func:`chain_blocks` lists; K2's ``db``
# sums each row tile, then the tiles in order.  :func:`chain_gate` states
# how far kernel and plain version may differ.
#
# K1's two variants (the reference's ``fold_bias`` and ``out_bf16``):
# with ``fold_bias`` layer 0's bias is a bf16 row of W_0 fed by a
# constant-1 column of the one-hot block, inside the product's sum, and
# the bias row added after it is zero (``y + 0`` is ``y``: the kernel
# needs no flag for it); ``out_bf16`` rounds the f32 output once to bf16
# (round to nearest even, as ``Tensor.to``), so K1's bf16 output equals
# the rounding of its own f32 output bit for bit.

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
    if cfg.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            "fused_tgt_forward requires cfg.dtype in {float32, bfloat16}")
    spec, steps, plan, a_slots, v_slots = _plan(cfg, structure)
    d_pad = _round_up(cfg.embed_dim, 128)
    if cfg.n_modes > d_pad:
        raise ValueError("n_modes must fit the one-hot width (<= d_pad)")
    return spec, steps, plan, a_slots, v_slots, d_pad


def _layer_matrices(model, cfg, spec, steps, plan, a_slots, v_slots,
                    edge_rel, edge_norm, d_pad, fold_bias0=False):
    """Per-layer block weight matrix ``[k_l, n_l]`` and bias row
    ``[n_l]``, both f32 and differentiable in the parameters and
    ``edge_norm`` (the port's counterpart of the reference's ``jax.vjp``
    through this assembly).  Layer-0 rows: one d_pad block per anchor
    slot (``a_slots`` order), then the packed variable block (or one
    block per variable slot when packing does not fit); later layers
    follow the previous layer's out_slots.  The reference's bias is an
    ``[8, n_l]`` tile whose row 0 is this row.

    ``fold_bias0``: layer 0's bias moves into W_0, at row ``n_a * d_pad
    + n_var * m8`` (the packed one-hot block's first unused column, which
    :func:`_layer0_operand` sets to 1), so it rounds to bf16 with the rest
    of W_0; layer 0's bias row is then zero (:func:`_check_fold` says
    when the layout has that column)."""
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
        fold = fold_bias0 and li == 0
        if fold:
            ones_row = n_a * d_pad + len(v_slots) * m8
            for s in out_slots:
                W[ones_row, ocol[s] * d_pad:ocol[s] * d_pad + d] += \
                    lp.bias.to(f32)
        Ws.append(W)
        bias = torch.zeros((len(out_slots) * d_pad,), dtype=f32, device=dev)
        if not fold:
            for s in out_slots:
                bias[ocol[s] * d_pad:ocol[s] * d_pad + d] = lp.bias.to(f32)
        biases.append(bias)
    return Ws, biases


def _check_fold(cfg, v_slots, d_pad: int) -> None:
    """The reference's refusal of ``fold_bias`` (same message): the
    packed one-hot block needs a column no variable slot uses."""
    packed, m8 = _var_layout(cfg, len(v_slots), d_pad)
    if not (packed and v_slots and len(v_slots) * m8 < d_pad):
        raise ValueError(
            "fold_bias needs a free column in the packed one-hot block "
            "(packed layout with n_var * round_up(n_modes, 8) < d_pad)")


def _layer0_operand(cols, node_mode, v_slots, cfg, d_pad,
                    wire=torch.bfloat16, fold_bias=False) -> torch.Tensor:
    """``X_0 [B, k_0]`` in the wire type: the anchor rows (one d_pad
    block each, zero-padded), then the variable one-hot block(s).  The
    packed block sets column ``k * m8 + mode`` for the k-th variable
    slot, as the reference's in-kernel expansion does (its
    ``onehot_operand`` variant builds the same values outside), and with
    ``fold_bias`` also column ``n_var * m8``, the constant 1 that feeds
    W_0's folded bias row."""
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
            if fold_bias:
                oh |= iota == len(v_slots) * m8
            parts.append(oh.to(wire))
        else:
            parts += [(modes[:, k:k + 1] == iota).to(wire)
                      for k in range(len(v_slots))]
    return torch.cat(parts, dim=1).contiguous()


def _round_to(x: torch.Tensor, wire) -> torch.Tensor:
    return x.to(wire).to(torch.float32)


def _chain_forward_plain(x0, ws, bs, d: int, mm=None,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K1's kernel: ``[B, d]`` in ``out_dtype`` (f32,
    or bf16 for ``out_bf16``: the f32 result rounded once) from the
    layer-0 operand, the wire-typed weights and the f32 bias rows.
    ``mm(x, w, k)`` takes the products (``_ordered_matmul`` unless given:
    the reordering emulation of ``tools/tgt_probe.py`` passes another)."""
    mm = mm or _ordered_matmul
    wire = x0.dtype
    x = x0.to(torch.float32)
    L = len(ws)
    for li in range(L):
        y = mm(x, ws[li].to(torch.float32), x.shape[1]) + bs[li]
        if li < L - 1:
            x = _round_to(torch.relu(y), wire)
    return y[:, :d].to(out_dtype).contiguous()


def _partitioned_sums(x, gb, g, R: int, mm=None):
    """``(x^T gb, sum_rows g)`` summed per R-row partition, rows
    ascending, then over the partitions in order (K2's reduction);
    with ``mm`` each partition's ``x^T gb`` is ``mm(x_p^T, gb_p, R)``."""
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
        if mm is None:
            acc_w = acc_w + xp[:, r, :, None] * gbp[:, r, None, :]
        acc_b = acc_b + gp[:, r]
    if mm is not None:
        acc_w = torch.stack([mm(xp[p].t(), gbp[p], R) for p in range(P)])
    dw, db = x.new_zeros((k, n)), x.new_zeros((n,))
    for p in range(P):
        dw = dw + acc_w[p]
        db = db + acc_b[p]
    return dw, db


def _chain_backward_plain(x0, ws, bs, g, n_a: int, d: int, d_pad: int,
                          mm=None):
    """Plain version of K2's kernels → ``(dA [B, n_a, d], [dW_l],
    [db_l])``: recompute the chain, then per layer from the last
    ``dW_l = X_l^T bf16(g)``, ``db_l = sum_rows g``,
    ``g <- (bf16(g) @ W_l^T) * [Y_{l-1} > 0]``, and at layer 0 the anchor
    column blocks of ``bf16(g) @ W_0^T``.  With an f32 ``x0`` (the
    reference's ``f32_wire``, tests only) nothing rounds to bf16.  ``mm``
    as in :func:`_chain_forward_plain`."""
    wire, f32 = x0.dtype, torch.float32
    B = x0.shape[0]
    L = len(ws)
    R = _partition_rows(B)
    order = mm or _ordered_matmul
    xs, ys = [x0.to(f32)], []
    for li in range(L - 1):
        y = order(xs[-1], ws[li].to(f32), xs[-1].shape[1]) + bs[li]
        ys.append(y)
        xs.append(_round_to(torch.relu(y), wire))
    gl = F.pad(g.to(f32), (0, ws[-1].shape[1] - d))
    dws, dbs = [None] * L, [None] * L
    da = None
    for li in range(L - 1, -1, -1):
        gb = _round_to(gl, wire)
        dws[li], dbs[li] = _partitioned_sums(xs[li], gb, gl, R, mm)
        w = ws[li].to(f32)
        n_l = w.shape[1]
        if li > 0:
            dx = order(gb, w.t(), n_l)
            gl = torch.where(ys[li - 1] > 0, dx, dx.new_zeros(()))
        else:
            dx = order(gb, w[:n_a * d_pad].t(), n_l)
            da = dx.view(B, n_a, d_pad)[:, :, :d].contiguous()
    return da, dws, dbs


# ----------------------------------------------------------------------
# The blocks of W_l the kernels multiply
# ----------------------------------------------------------------------
CHUNK = 128  # the kernels' output columns per chunk (csrc/fused_tgt.cu NC)
K_TILE = 32  # contraction rows of one tile-table entry (csrc KT)
_T_LAST, _T_NEWLAYER = 1, 2  # tile-table flags (csrc T_LAST, T_NEWLAYER)


class ChainBlocks:
    """The d_pad x d_pad blocks of each ``W_l`` that
    :func:`_layer_matrices` can make nonzero, derived from the structure's
    plan alone (never from the weights): ``pairs[l]`` lists ``(k-block,
    n-block)`` sorted by n-block, then k-block.  The kernels multiply only
    these; every other block is zero by construction, so skipping it
    changes nothing.  Layer 0's k-blocks from ``n_anchor`` on are the
    variable one-hot block(s).  The kernels' tile tables are built from it
    once per device (:meth:`tables`)."""

    def __init__(self, d_pad: int, ks, ns, pairs, n_anchor: int):
        self.d_pad = d_pad
        self.ks, self.ns = tuple(ks), tuple(ns)
        self.pairs = tuple(tuple(p) for p in pairs)
        self.n_anchor = n_anchor
        self._tables: Dict[tuple, dict] = {}

    def mask(self, li: int) -> torch.Tensor:
        """``[k_l, n_l]`` bool: True on the listed blocks of layer li."""
        dp = self.d_pad
        m = torch.zeros((self.ks[li] // dp, self.ns[li] // dp),
                        dtype=torch.bool)
        for kb, nb in self.pairs[li]:
            m[kb, nb] = True
        return m.repeat_interleave(dp, 0).repeat_interleave(dp, 1)

    def _chunks(self, li: int, rev: int, ncols: int):
        """Layer li's chunks of output columns below ``ncols``, each a list
        of tiles (layer, direction, column, contraction start): forward
        over the k-blocks that feed the chunk's n-block, reverse over the
        n-blocks that its k-block feeds."""
        dp = self.d_pad
        out = []
        for c0 in range(0, ncols, CHUNK):
            blk = c0 // dp
            srcs = sorted(n if rev else k for k, n in self.pairs[li]
                          if (k if rev else n) == blk)
            if not srcs:
                raise ValueError(f"layer {li}: block {blk} meets no listed "
                                 f"weight block")
            out.append([(li, rev, c0, src * dp + kt) for src in srcs
                        for kt in range(0, dp, K_TILE)])
        return out

    @staticmethod
    def _flatten(layers) -> List[tuple]:
        """int4 rows (layer | direction << 4 | flags << 8, column, k, 0)
        of a list of layers, each a list of chunks of tiles."""
        rows = []
        for chunks in layers:
            first = True
            for chunk in chunks:
                for i, (li, rev, c0, k0) in enumerate(chunk):
                    fl = (_T_LAST if i == len(chunk) - 1 else 0) | (
                        _T_NEWLAYER if first else 0)
                    first = False
                    rows.append((li | rev << 4 | fl << 8, c0, k0, 0))
        return rows

    def host_tables(self, d: int) -> dict:
        """The kernels' tables as lists: ``fwd`` (K1's tiles: every
        layer, the last one's chunks below d), ``bwd`` (K2 pass A: the
        recompute of layers 0..L-2, then the reverse sweep from L-1 down,
        at layer 0 only the anchor columns), ``jobs`` (pass B: layer, row,
        column of each listed 128 x 128 block of dW), ``jobmap`` (per
        layer ``[k_l / 128][n_l / 128]``: job or -1, flat) and ``jm_off``."""
        L, dp = len(self.ks), self.d_pad
        fwd = [self._chunks(li, 0, self.ns[li] if li < L - 1
                            else _round_up(d, CHUNK)) for li in range(L)]
        rec = [self._chunks(li, 0, self.ns[li]) for li in range(L - 1)]
        rev = [self._chunks(li, 1, self.ks[li] if li else self.n_anchor * dp)
               for li in range(L - 1, -1, -1)]
        jobs, jobmap, jm_off = [], [], []
        sub = dp // CHUNK
        for li in range(L):
            m = [[-1] * (self.ns[li] // CHUNK)
                 for _ in range(self.ks[li] // CHUNK)]
            for kb, nb in self.pairs[li]:
                for i in range(sub):
                    for j in range(sub):
                        m[kb * sub + i][nb * sub + j] = len(jobs)
                        jobs.append((li, (kb * sub + i) * CHUNK,
                                     (nb * sub + j) * CHUNK, 0))
            jm_off.append(len(jobmap))
            jobmap += [v for row in m for v in row]
        return {"fwd": self._flatten(fwd), "bwd": self._flatten(rec + rev),
                "jobs": jobs, "jobmap": jobmap, "jm_off": jm_off}

    def tables(self, d: int, dev) -> dict:
        """:meth:`host_tables` as int32 tensors on ``dev`` (cached)."""
        key = (d, str(dev))
        got = self._tables.get(key)
        if got is None:
            host = self.host_tables(d)
            got = {k: (torch.tensor(v, dtype=torch.int32, device=dev)
                       if k != "jm_off" else v) for k, v in host.items()}
            self._tables[key] = got
        return got


_BLOCKS: Dict[tuple, ChainBlocks] = {}


def chain_blocks(cfg, structure: str, fold_bias: bool = False
                 ) -> ChainBlocks:
    """K1/K2's block list for ``structure`` under ``cfg``, from ``_plan``
    once per (config, structure, fold_bias) and cached (the train step
    asks twice a step): per layer each distinct (source slot, output
    slot) pair of :func:`_layer_matrices` (the self transforms and every
    edge), in blocks of d_pad, the layer-0 variable slots folded into
    their one-hot block(s).  With ``fold_bias`` the packed variable block
    is listed against every output block of layer 0 as well: its folded
    bias row feeds them all (an unlisted block would drop the bias)."""
    key = (cfg, structure, bool(fold_bias))
    got = _BLOCKS.get(key)
    if got is None:
        got = _BLOCKS[key] = _derive_blocks(cfg, structure, bool(fold_bias))
    return got


def _derive_blocks(cfg, structure: str, fold_bias: bool) -> ChainBlocks:
    spec, steps, plan, a_slots, v_slots, d_pad = _checked_chain_plan(
        cfg, structure)
    if fold_bias:
        _check_fold(cfg, v_slots, d_pad)
    packed, _ = _var_layout(cfg, len(v_slots), d_pad)
    n_a = len(a_slots)
    a_idx = {s: k for k, s in enumerate(a_slots)}
    v_idx = {s: k for k, s in enumerate(v_slots)}
    ks, ns, pairs = [], [], []
    for li, (in_slots, out_slots, edges) in enumerate(plan):
        ocol = {s: k for k, s in enumerate(out_slots)}
        if li == 0:
            def src(s):
                if s in v_idx:
                    return n_a if packed else n_a + v_idx[s]
                return a_idx[s]
            ks.append((n_a + (1 if packed else len(v_slots))) * d_pad
                      if v_slots else n_a * d_pad)
        else:
            icol = {s: k for k, s in enumerate(in_slots)}

            def src(s):
                return icol[s]
            ks.append(len(in_slots) * d_pad)
        ns.append(len(out_slots) * d_pad)
        links = {(s, s) for s in out_slots} | {
            (spec.edge_src[j], spec.edge_dst[j]) for j in edges}
        blocks = {(src(s), ocol[t]) for s, t in links}
        if fold_bias and li == 0:
            blocks |= {(n_a, ocol[t]) for t in out_slots}
        pairs.append(sorted(blocks, key=lambda p: (p[1], p[0])))
    return ChainBlocks(d_pad, ks, ns, pairs, n_a)


# ----------------------------------------------------------------------
# The gate: kernel against plain version
# ----------------------------------------------------------------------
# K1, K2 and K3 take each product's K-deep sum in the tensor cores' order,
# the plain versions one by one (K3's gate, :func:`multi_gate`, holds its
# output to the forward form below and adds a check layer by layer).
# Both sum the same exact bf16 x bf16 products, so before any bf16 rounding the two differ by f32
# reassociation only: at most 2 (K - 1) 2^-24 of the sum of |terms| per
# element, ~1e-7 of the leaf's max at these widths (measured: <= 2.1e-7
# at d = 128; ``tools/tgt_probe.py emulate``).  A chain of one layer has
# no bf16 rounding after a product, nor has db of the last layer: there
# the gate is FLIP_FREE_TOL.  Deeper chains round ``X_{l+1} =
# bf16(relu(Y_l))`` and ``gb = bf16(g)``; a last-bit difference next to
# a rounding boundary flips that value by one bf16 step (2^-8 of it), or
# a ReLU mask where ``Y`` is ~0, and the flip moves its row of the output
# and, in K2, its row and column of the gradients.  Those are bounded by
# the TPU kernel's own envelope (``tests/test_torch_port_fused_tgt.py``,
# the seed sweep): rows of K1's output (and of dA) within ROW_MAX of the
# max|ref| with at most SHARE of them beyond NOISE; each K2 leaf within
# LEAF_MAX elementwise, at most SHARE beyond NOISE, and, since a flip
# moves few elements while a wrong input moves a whole rank-one slice, a
# mean|diff| / mean|ref| within LEAF_MEAN.  The emulation at d = 128, B =
# 512 and 1,000, 7 structures, 4 seeds, biases 0 or N(0, 0.1), another
# sum order (exact then rounded; or 16-deep exact steps added in f32)
# reached rows 1.1e-3 (share 2.0 %), dA rows 5.7e-4, leaves 5.7e-4 (share
# 0.3 %), leaf means 1.7e-5: inside the envelope, which is kept as it is.
# Both negative controls (one nonzero block of W_0 zeroed; one query's
# anchor row moved 8 bf16 steps) fail it in every structure.
FLIP_FREE_TOL = 1e-4
ROW_MAX = 2e-3
LEAF_MAX = 2e-2
NOISE = 1e-4
SHARE = 0.1
LEAF_MEAN = 1e-4


def _row_figures(got: torch.Tensor, want: torch.Tensor):
    rows = (got - want).abs().reshape(got.shape[0], -1).amax(1)
    scale = float(want.abs().max())
    if scale == 0:
        return (0.0 if not bool(got.ne(0).any()) else float("inf")), 0.0
    r = rows / scale
    return float(r.max()) if r.numel() else 0.0, float(
        (r > NOISE).float().mean()) if r.numel() else 0.0


def _leaf_figures(got: torch.Tensor, want: torch.Tensor):
    """(max, share beyond NOISE, mean form) of |got - want| against the
    leaf's max|want| (mean|want| for the mean form)."""
    diff = (got - want).abs()
    scale = float(want.abs().max())
    if scale == 0:
        bad = float("inf") if bool(got.ne(0).any()) else 0.0
        return bad, (1.0 if bad else 0.0), bad
    e = diff / scale
    return (float(e.max()), float((e > NOISE).float().mean()),
            float(diff.mean() / want.abs().mean()))


def chain_gate(got, want, n_layers: int, blocks: ChainBlocks = None) -> dict:
    """Kernel ``got`` against plain ``want`` (see the constants above).

    K1: ``got``, ``want`` are ``[B, d]`` outputs.  K2: ``(dA, [dW_l],
    [db_l])`` triples; each dW_l is compared on the blocks ``blocks``
    lists and must be exactly 0 elsewhere in ``got``.
    Returns ``ok`` and the figures it was decided on."""
    if isinstance(got, torch.Tensor):
        if n_layers == 1:
            e = _leaf_figures(got, want)[0]
            return {"ok": e <= FLIP_FREE_TOL, "max": e}
        mx, share = _row_figures(got, want)
        return {"ok": mx <= ROW_MAX and share <= SHARE, "row_max": mx,
                "row_share": share}
    da, dws, dbs = got
    wda, wdws, wdbs = want
    leaves, zero_ok = [(da, wda)], True
    for li, (a, b) in enumerate(zip(dws, wdws)):
        m = blocks.mask(li).to(a.device)
        zero_ok &= not bool(a[~m].ne(0).any())
        leaves.append((a[m], b[m]))
    leaves += list(zip(dbs[:-1], wdbs[:-1]))
    figs = [_leaf_figures(a, b) for a, b in leaves]
    last_db = _leaf_figures(dbs[-1], wdbs[-1])[0]
    out = {"zero_ok": zero_ok, "last_db": last_db,
           "leaf_max": max(f[0] for f in figs),
           "leaf_share": max(f[1] for f in figs),
           "leaf_mean": max(f[2] for f in figs)}
    if n_layers == 1:
        ok = out["leaf_max"] <= FLIP_FREE_TOL
    else:
        out["row_max"], out["row_share"] = _row_figures(da, wda)
        ok = (out["leaf_max"] <= LEAF_MAX and out["leaf_share"] <= SHARE
              and out["leaf_mean"] <= LEAF_MEAN
              and out["row_max"] <= ROW_MAX and out["row_share"] <= SHARE)
    out["ok"] = ok and zero_ok and last_db <= FLIP_FREE_TOL
    return out


def chain_gate_controls(x0, ws, blocks: ChainBlocks, n_a: int, d: int):
    """The two negative controls of :func:`chain_gate` as ``(name, x0,
    ws)``: a plain version fed these must fail the gate against the
    kernel's output.  ``zero_block``: the first listed block of W_0 whose
    source is an anchor, zeroed; ``anchor_row``: query 0's first anchor
    row moved 8 bf16 steps up (3 % of each element)."""
    dp = blocks.d_pad
    kb, nb = next(p for p in blocks.pairs[0] if p[0] < n_a)
    w0 = ws[0].clone()
    w0[kb * dp:(kb + 1) * dp, nb * dp:(nb + 1) * dp] = 0
    x = x0.clone()
    x[0, :d] = (x[0, :d].view(torch.int16) + 8).view(x0.dtype)
    return (("zero_block", x0, [w0, *ws[1:]]), ("anchor_row", x, list(ws)))


# K2's parameter gradients (the chain's dA, dW_l and db_l mapped by
# autograd through :func:`_layer_matrices`, which sums each basis
# gradient over edges and coefficients of both signs) against the plain
# K2's, per leaf in mean|diff| / mean|ref|, the worst leaf, by the
# structure's depth.  ``chain_gate`` holds the chain triples; the
# assembly's cancellations lift small relative differences in a few
# leaves (the coefficients of the few relations a formula uses) above
# its LEAF_MEAN.  ``tools/tgt_probe.py emulate`` (the chain in another
# sum order, exact then rounded, mapped through the assembly of a bf16
# model: d = 128, 16 bases, B = 512 and 1,000, the 7 structures, seeds 0
# to 3, biases 0 or N(0, 0.1)) reached 2.7e-4 at one layer, 5.7e-4 at
# two and 6.8e-4 at three; the limits are about 3x those.  The negative
# control (:func:`param_grad_control`) moves one basis's gradient by
# PARAM_CONTROL_FACTOR times the limit: the limit fails it, the depth
# tolerance K2's gradients were held to before (3e-2 / 8e-2 / 2.5e-1,
# against f32 autograd) does not.
PARAM_GRAD_MEAN_BY_DEPTH = {1: 1e-3, 2: 2e-3, 3: 2e-3}
PARAM_CONTROL_FACTOR = 4.0
# K2's parameter gradients against autograd of the f32 encoder (bf16
# operands against f32), per leaf in mean|diff| / mean|ref|, by depth:
# the reference's tolerances (tests/test_pallas_fused_fwd.py:261) in the
# mean form of its chip check (tools/tpu_smoke.py:185-190)
F32_GRAD_MEAN_BY_DEPTH = {1: 3e-2, 2: 8e-2, 3: 2.5e-1}


def param_grad_mean_err(got: Dict[str, torch.Tensor],
                        want: Dict[str, torch.Tensor]) -> float:
    """max over leaves of mean|got - want| / mean|want| (in f32; leaves
    where ``want`` is zero everywhere are skipped)."""
    worst = 0.0
    for name, w in want.items():
        w = w.to(torch.float32)
        if bool(w.abs().max() > 0):
            worst = max(worst, float((got[name].to(torch.float32) - w).abs()
                                     .mean() / w.abs().mean()))
    return worst


def param_grad_control(got: Dict[str, torch.Tensor],
                       want: Dict[str, torch.Tensor],
                       n_layers: int) -> Dict[str, torch.Tensor]:
    """:func:`param_grad_mean_err`'s negative control: ``got`` (in f32)
    with layer 0's basis 0 gradient scaled by ``1 + s``, ``s`` chosen so
    that the leaf's mean|diff| / mean|ref| grows by PARAM_CONTROL_FACTOR
    times the depth's limit (a wrong gradient of one basis, which the
    assembly's sum over bases would carry into every relation)."""
    out = {n: t.to(torch.float32) for n, t in got.items()}
    g = out["layers.0.basis"].clone()
    target = PARAM_CONTROL_FACTOR * PARAM_GRAD_MEAN_BY_DEPTH[n_layers]
    s = target * float(want["layers.0.basis"].to(torch.float32).abs().sum()
                       / g[0].abs().sum())
    g[0] = g[0] * (1.0 + s)
    out["layers.0.basis"] = g
    return out


# K3's gate.  The output, end to end, is held to :func:`chain_gate` over
# ``num_steps`` layers: K3's products are K1's and its other steps keep
# the plain order.  That envelope lets a flip near a bf16 rounding
# boundary move a row by up to ROW_MAX of max|ref|, so a wrong input of
# one query that moves its row by less passes it (an anchor row moved 8
# bf16 steps, three layers from the output, moves it by 3e-4 to 3e-3 of
# the row's own max, and less of max|ref|).  So each layer is held, too,
# against the plain layer applied to the kernel's own input rows (its
# activations, kept by :func:`fused_tgt_forward_multi_layers`), where no
# rounding comes between the reordered sum and the comparison:
# * a layer before the last writes ``bf16(relu(y))``: each element equal
#   to the plain one or one bf16 step from it (a flip), or both within
#   FLIP_FREE_TOL of the slot's max (a ReLU mask flipped where ``y`` is
#   ~0), and at most MOVED_SHARE of the elements (or one) not equal;
# * the last layer's ``y``: each row within FLIP_FREE_TOL of the row's own
#   max|ref| (the sums differ by f32 reassociation only, ~1e-7).
# A wrong input row, relation, coefficient or norm of one query moves
# many elements of its row in the layer that reads it by several steps,
# whatever the depth.  MOVED_SHARE: a flip needs a reordered sum within
# its last bits of a bf16 rounding boundary, so flips are rare and
# independent (one element allowed whatever the batch); a systematic
# error of one step (a rounding mode, a precision) moves a large share.
# ``tools/k3_probe.py emulate`` (the products summed exactly, then
# rounded once; d = 16, 128, 160, 400 at B = 20, 256, 1,000, the 7
# structures, 4 seeds) stays within one step everywhere and moves at
# most 3.9e-4 of a layer's elements (one element, at B = 20; 2.1e-4 at
# B >= 256); the last layer's rows reach 6.2e-7; both controls fail at
# queries 0, B/2 and B - 1 in every case, the thinnest at 4 steps.
MOVED_SHARE = 1e-3


def _layer_figures(got: torch.Tensor, want: torch.Tensor):
    """(largest distance in bf16 steps, number of elements not equal) of
    one layer's ``[B, d]`` activations, ``got`` the kernel's, ``want``
    the plain layer's from the same input rows; both bf16-valued, >= 0."""
    g, w = got.to(torch.bfloat16), want.to(torch.bfloat16)
    steps = (g.view(torch.int16).int() - w.view(torch.int16).int()).abs()
    near0 = torch.maximum(g.float(), w.float()) <= (
        FLIP_FREE_TOL * float(w.float().max()))
    steps = torch.where(near0, steps.new_zeros(()), steps)
    return (float(steps.max()) if steps.numel() else 0.0,
            int(g.ne(w).sum()))


def _last_layer_figure(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max|got - want| / the row's max|want|."""
    if not got.numel():
        return 0.0
    diff = (got - want).abs().amax(1)
    scale = want.abs().amax(1)
    r = torch.where(scale > 0, diff / scale,
                    torch.where(diff > 0, float("inf"), 0.0))
    return float(r.max())


def multi_gate(cfg, structure: str, operands: FusedMultiOperands, args,
               got: torch.Tensor, acts, want: torch.Tensor = None) -> dict:
    """K3's output ``got`` and activations ``acts`` (from
    :func:`fused_tgt_forward_multi_layers`) against the plain version on
    the inputs ``args = (node_entity, node_mode, edge_rel_q,
    edge_norm_q)`` (see the constants above); ``want``, the plain output,
    is computed unless given.  Returns ``ok`` and the figures it was
    decided on: :func:`chain_gate`'s, ``steps`` and ``moved`` (the
    worst layer before the last: bf16 steps, share of elements not
    equal) and ``last``."""
    spec, steps, plan, a_slots, _ = _checked_plan(cfg, structure)
    ops = operands
    ne, nm, er, en = args
    if want is None:
        want = _multi_forward_plain(cfg, structure, *args, ops,
                                    _ordered_matmul)[0]
    out = chain_gate(got, want, steps)
    x = _multi_anchor_rows(ops, ne, a_slots)
    worst, moved, moved_ok = 0.0, 0.0, True
    for li in range(steps):
        y = _multi_layer_plain(ops, spec, plan, li, x, nm, er, en,
                               _ordered_matmul)
        if li == steps - 1:
            out["last"] = _last_layer_figure(got,
                                             y[spec.target_slot][:, :ops.d])
            break
        x = {}
        for s, v in y.items():
            k = acts[li + 1][s].to(torch.float32)
            st, n_moved = _layer_figures(k[:, :ops.d],
                                         torch.relu(v[:, :ops.d]))
            n = max(k[:, :ops.d].numel(), 1)
            worst, moved = max(worst, st), max(moved, n_moved / n)
            moved_ok &= n_moved <= max(1.0, MOVED_SHARE * n)
            x[s] = k
    out["steps"], out["moved"] = worst, moved
    out["ok"] = (out["ok"] and worst <= 1 and moved_ok
                 and out["last"] <= FLIP_FREE_TOL)
    return out


def _tgt_kernel():
    """The built K1/K2 library, argument types set (cached)."""
    global _TGT_KERNEL
    if _TGT_KERNEL is None:
        lib = cuda_build.load_library("fused_tgt", ["fused_tgt.cu"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mpqe_tgt_forward.argtypes = [p, i, i, p, p, p, p, p, i, p, i, i,
                                         i, p]
        lib.mpqe_tgt_forward.restype = i
        lib.mpqe_tgt_backward.argtypes = [
            p, i, i, p, p, p, p, p, i, p, i, p, p, p, i, i, i, p, p, p, p,
            i, i, i, p, p, p]
        lib.mpqe_tgt_backward.restype = i
        lib.mpqe_tgt_smem_bytes.argtypes = [i, i, i, p, p]
        lib.mpqe_tgt_smem_bytes.restype = ll
        lib.mpqe_tgt_max_smem.argtypes = [i]
        lib.mpqe_tgt_max_smem.restype = ll
        lib.mpqe_tgt_k_tile.argtypes = []
        lib.mpqe_tgt_k_tile.restype = i
        if lib.mpqe_tgt_k_tile() != K_TILE:
            raise RuntimeError("csrc/fused_tgt.cu KT differs from K_TILE")
        _TGT_KERNEL = lib
    return _TGT_KERNEL


_TGT_KERNEL = None
MAX_LAYERS = 8  # the CUDA source's MAXL
ROW_TILES = (128, 64, 32, 16)  # rows per block, largest first; 8 if none fits


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


def _row_tile(lib, bwd: int, B: int, ks, ns, dev) -> int:
    """Rows per block: the largest of ROW_TILES that still gives every SM
    a block (the smallest whatever B) and whose shared memory fits the
    card, else 8 (half-empty tensor-core tiles); raises ValueError when
    not even that fits.  Cached per (kernel, batch, widths, card)."""
    with torch.cuda.device(dev):
        idx = torch.cuda.current_device()
    key = (bwd, B, tuple(ks), tuple(ns), idx)
    tq = _ROW_TILE.get(key)
    if tq is not None:
        return tq
    have = lib.mpqe_tgt_max_smem(idx)
    n_sm = torch.cuda.get_device_properties(idx).multi_processor_count
    for tq in ROW_TILES + (8,):
        if tq > ROW_TILES[-1] and -(-B // tq) < n_sm:
            continue
        need = lib.mpqe_tgt_smem_bytes(bwd, tq, len(ks), _ints(ks), _ints(ns))
        if 0 < need <= have:
            _ROW_TILE[key] = tq
            return tq
    raise ValueError(f"layer widths {list(zip(ks, ns))} need more shared "
                     f"memory per block than the card's {have} bytes")


_ROW_TILE: Dict[tuple, int] = {}


def _check_blocks(blocks: ChainBlocks, ks, ns, anchor_cols: int) -> None:
    """Raise unless ``blocks`` lists blocks of this chain's widths, with
    ``anchor_cols`` anchor columns in layer 0."""
    if blocks.ks != tuple(ks) or blocks.ns != tuple(ns):
        raise ValueError(f"block list for widths {blocks.ks} -> {blocks.ns},"
                         f" chain {tuple(ks)} -> {tuple(ns)}")
    if blocks.n_anchor * blocks.d_pad != anchor_cols:
        raise ValueError(f"block list for {blocks.n_anchor} anchor blocks "
                         f"of {blocks.d_pad}, not {anchor_cols} columns")


def _chain_forward(x0, ws, bs, d: int, blocks: ChainBlocks,
                   out_dtype=torch.float32) -> torch.Tensor:
    """K1's kernel on CUDA tensors (checked, launched on the current
    stream, counted in ``fused_tgt_forward.launches``), multiplying the
    blocks ``blocks`` lists, its ``[B, d]`` output written in
    ``out_dtype`` (f32, or bf16: ``out_bf16``); the plain version on CPU
    tensors; any other device raises."""
    dev = x0.device
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K1 writes float32 or bfloat16, not {out_dtype}")
    if dev.type == "cpu":
        return _chain_forward_plain(x0, ws, bs, d, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_tgt_forward: unsupported device {dev}")
    ks, ns = _check_chain(x0, ws, bs)
    if ns[-1] < d:
        raise ValueError(f"last layer has {ns[-1]} columns, fewer than d={d}")
    _check_blocks(blocks, ks, ns, blocks.n_anchor * blocks.d_pad)
    B = x0.shape[0]
    out = torch.empty((B, d), dtype=out_dtype, device=dev)
    if B == 0:
        return out
    lib = _tgt_kernel()
    tq = _row_tile(lib, 0, B, ks, ns, dev)
    tiles = blocks.tables(d, dev)["fwd"]
    with torch.cuda.device(dev):
        err = lib.mpqe_tgt_forward(
            x0.data_ptr(), B, len(ws), _ints(ks), _ints(ns), _ptrs(ws),
            _ptrs(bs), tiles.data_ptr(), tiles.shape[0], out.data_ptr(),
            int(out_dtype == torch.bfloat16), d, tq,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tgt kernel launch failed: cudaError {err}")
    fused_tgt_forward.launches += 1
    return out


def _chain_backward(x0, ws, bs, g, n_a: int, d: int, d_pad: int,
                    blocks: ChainBlocks):
    """K2's kernels on CUDA tensors (checked, launched on the current
    stream, counted in ``fused_tgt_backward.launches``); the plain
    version on CPU tensors; any other device raises.  Scratch (the
    recomputed activations, bf16 cotangents, per-tile db sums and the
    partitions' dW) comes from ``torch.empty``.  dW blocks off the list
    are 0."""
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
    if ns[-1] < d or n_a < 1 or n_a * d_pad > ks[0] or d_pad % 128:
        raise ValueError("anchor blocks or d do not fit the chain")
    _check_blocks(blocks, ks, ns, n_a * d_pad)
    f32, bf16 = torch.float32, torch.bfloat16
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
    lib = _tgt_kernel()
    tq = _row_tile(lib, 1, B, ks, ns, dev)
    tab = blocks.tables(d, dev)
    R = _partition_rows(B)
    P = -(-B // R)
    xg = [x0] + [torch.empty((B, k), dtype=bf16, device=dev)
                 for k in ks[1:]]
    gg = [torch.empty((B, n), dtype=bf16, device=dev) for n in ns]
    dbp = torch.empty((-(-B // tq), sum(ns)), dtype=f32, device=dev)
    n_jobs = tab["jobs"].shape[0]
    partial = torch.empty((P, n_jobs, CHUNK, CHUNK), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mpqe_tgt_backward(
            x0.data_ptr(), B, L, _ints(ks), _ints(ns), _ptrs(ws), _ptrs(bs),
            tab["bwd"].data_ptr(), tab["bwd"].shape[0],
            tab["jobs"].data_ptr(), n_jobs, tab["jobmap"].data_ptr(),
            _ints(tab["jm_off"]), g.data_ptr(), d, d_pad, n_a,
            da.data_ptr(), _ptrs(xg), _ptrs(gg), dbp.data_ptr(), tq, R, P,
            partial.data_ptr(), flat.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
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
              edge_norm, anchor_rows, fold_bias=False):
    spec, steps, plan, a_slots, v_slots, d_pad = _checked_chain_plan(
        cfg, structure)
    if fold_bias:
        _check_fold(cfg, v_slots, d_pad)
    cols = _anchor_cols(model, node_entity, a_slots, anchor_rows)
    Ws, biases = _layer_matrices(model, cfg, spec, steps, plan, a_slots,
                                 v_slots, edge_rel, edge_norm, d_pad,
                                 fold_bias0=fold_bias)
    return v_slots, d_pad, cols, Ws, biases


class FusedChain(torch.autograd.Function):
    """K1 forward, K2 backward, over the assembled operands: ``apply(
    node_mode, layout, *cols, *Ws, *biases)`` with ``layout = (cfg,
    v_slots, d_pad, n_anchor_cols, blocks, fold_bias, out_bf16)``
    (``blocks``: :func:`chain_blocks` for ``fold_bias``).  With
    ``out_bf16`` K1 writes bf16 and the output is that cast to
    ``cfg.dtype``, as the reference's wrapper returns it; the cotangent
    is taken in f32 either way.  Gradients go to the anchor rows and to
    the f32 ``W_l`` / bias rows (the bf16 wire cast passes them straight
    through, as in the reference), so autograd carries them on through
    :func:`_layer_matrices` (a folded bias through W_0's row) and the
    anchor gather."""

    @staticmethod
    def forward(ctx, node_mode, layout, *tensors):
        cfg, v_slots, d_pad, n_a, blocks, fold_bias, out_bf16 = layout
        L = (len(tensors) - n_a) // 2
        cols, Ws, bs = tensors[:n_a], tensors[n_a:n_a + L], tensors[n_a + L:]
        x0 = _layer0_operand(cols, node_mode, v_slots, cfg, d_pad,
                             fold_bias=fold_bias)
        ws = [W.to(torch.bfloat16).contiguous() for W in Ws]
        bs = [b.contiguous() for b in bs]
        ctx.save_for_backward(x0, *ws, *bs)
        ctx.meta = (n_a, L, cfg.embed_dim, d_pad, blocks)
        out = _chain_forward(x0, ws, bs, cfg.embed_dim, blocks,
                             torch.bfloat16 if out_bf16 else torch.float32)
        return out.to(cfg.dtype)

    @staticmethod
    def backward(ctx, g):
        n_a, L, d, d_pad, blocks = ctx.meta
        x0, *rest = ctx.saved_tensors
        ws, bs = rest[:L], rest[L:]
        da, dws, dbs = _chain_backward(
            x0, list(ws), list(bs), g.to(torch.float32).contiguous(), n_a,
            d, d_pad, blocks)
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
    *,
    fold_bias: bool = False,
    out_bf16: bool = False,
) -> torch.Tensor:
    """Whole pruned TGT forward of one formula's batch → ``[B, d]`` in
    ``cfg.dtype`` (float32 or bfloat16: the leaves go up to f32 in
    :func:`_layer_matrices` and the chain keeps its bf16 wire either
    way; a bf16 model's output is K1's bf16 store, ``out_bf16``).

    CUDA tensors: one launch of the hand-written kernel K1
    (``csrc/fused_tgt.cu``) on the current stream, counted in
    ``fused_tgt_forward.launches``; CPU tensors: its plain version.
    Differentiable through :func:`FusedChain` (K2 backward); the model's
    train path calls it through ``models.mpqe.encode_dense_fused``.

    The reference's variants: ``fold_bias`` moves layer 0's bias into
    W_0 through a constant-1 column of the packed one-hot block (the bias
    then rounds to bf16 with W_0; ``ValueError`` where the layout has no
    free column); ``out_bf16`` has K1 write its output in bf16, returned
    cast to ``cfg.dtype`` as the reference returns it.  The reference's
    ``block``, ``vmem_limit_mb``, ``onehot_operand`` and ``split_gemm``
    tile the TPU or compute the same function another way and have no
    counterpart here (the one-hot block is always built outside the
    kernel, as ``onehot_operand`` does)."""
    return _fused_apply(model, cfg, structure, node_entity, node_mode,
                        edge_rel, edge_norm, anchor_rows,
                        fold_bias=fold_bias, out_bf16=out_bf16)


fused_tgt_forward.launches = 0


def _fused_apply(model, cfg, structure, node_entity, node_mode, edge_rel,
                 edge_norm, anchor_rows, fold_bias=False, out_bf16=False):
    """Differentiable K1 (K2 backward) from the model's parameters; a
    bf16 model takes K1's bf16 store."""
    out_bf16 = out_bf16 or cfg.dtype == torch.bfloat16
    v_slots, d_pad, cols, Ws, bs = _assemble(
        model, cfg, structure, node_entity, node_mode, edge_rel, edge_norm,
        anchor_rows, fold_bias)
    return FusedChain.apply(node_mode, (cfg, tuple(v_slots), d_pad,
                                        len(cols),
                                        chain_blocks(cfg, structure,
                                                     fold_bias),
                                        bool(fold_bias), bool(out_bf16)),
                            *cols, *Ws, *bs)


def fused_tgt_forward_reference(model, cfg, structure, node_entity,
                                node_mode, edge_rel, edge_norm,
                                anchor_rows=None, *, fold_bias=False,
                                out_bf16=False) -> torch.Tensor:
    """Plain PyTorch version of K1 (no gradient): the kernel's rounding
    points and summation order, on any device; the variants as in
    :func:`fused_tgt_forward`."""
    out_bf16 = out_bf16 or cfg.dtype == torch.bfloat16
    with torch.no_grad():
        v_slots, d_pad, cols, Ws, bs = _assemble(
            model, cfg, structure, node_entity, node_mode, edge_rel,
            edge_norm, anchor_rows, fold_bias)
        x0 = _layer0_operand(cols, node_mode, v_slots, cfg, d_pad,
                             fold_bias=fold_bias)
        return _chain_forward_plain(
            x0, [W.to(torch.bfloat16) for W in Ws], bs, cfg.embed_dim,
            out_dtype=torch.bfloat16 if out_bf16 else torch.float32
        ).to(cfg.dtype)


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
    blocks = chain_blocks(cfg, structure)
    return _backward_with(
        lambda *a: _chain_backward(*a, blocks=blocks), model, cfg,
        structure, node_entity, node_mode, edge_rel, edge_norm, anchor_rows,
        g, torch.bfloat16)


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
