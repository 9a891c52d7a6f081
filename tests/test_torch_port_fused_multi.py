"""K3 in the PyTorch port (``mpqe_tpu_torch/ops/fused_fwd.py``) against
the JAX package's Pallas kernel ``fused_tgt_forward_multi``, run here in
interpret mode.  Inputs come from numpy with a seed, parameters from the
JAX ``init_mpqe``, carried across with ``model_from_numpy``.

Tolerances (max|diff| / max|ref|):
* plain K3 vs the Pallas kernel: 1e-4.  Same function and rounding
  points; only the f32 sum order inside the products differs (last-bit
  noise, ~1e-7).  That noise can round an inter-layer activation to the
  neighbouring bf16 value (a flip), which moves that query's output row
  by up to ~1.5e-3.  The fixed inputs of the first test have no flip
  (worst 1.7e-5).  The seed sweep holds a flip's shape instead: it
  touches few rows (at most 1 in 10 beyond 1e-4, all rows within 2e-3),
  where a wrong formula moves every row.  In a sweep of 12 seeds x 40
  rows x 14 cases one row flipped (7.9e-4, 3-chain at d=128, seed 11).
* plain K3 vs the f32 ``encode_dense_multi``: 3e-2, the JAX package's
  own bound for the same pair (tests/test_pallas_fused_fwd.py).

The card's K3 takes its products on the tensor cores, so it is held to
``multi_gate`` against the plain version (``chain_gate`` on the output,
and each layer against the plain layer from the kernel's own
activations); here the gate passes the plain version with its products
summed in another order (``_reordered_matmul``: exact, rounded once) and
fails both of ``multi_gate_controls`` on ordinary queries, for every
structure at the flagship width and at d = 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import pallas_fused_fwd as jff
from mpqe_tpu.queries import STRUCTURE_NAMES, STRUCTURES
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import fused_fwd as tff

N_ENT, N_MODES, N_RELS = 300, 4, 12
WIDTHS = [(16, 4), (128, 16)]  # (embed_dim, num_bases)
_CACHE = {}


def _models(d, nb, readout="tgt"):
    key = (d, nb, readout)
    if key not in _CACHE:
        kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
                  embed_dim=d, n_layers=3, num_bases=nb, readout=readout)
        jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
        params = jm.init_mpqe(jax.random.PRNGKey(d + (nb or 0)), jcfg)
        rng = np.random.default_rng(d)
        for lp in params["layers"]:  # non-zero biases (init is zeros)
            lp["bias"] = jnp.asarray(
                0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
        model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _CACHE[key] = (jcfg, tcfg, params, model)
    return _CACHE[key]


def _inputs(structure, B=20, seed=0):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_RELS, (B, spec.n_edges)).astype(np.int32),
            rng.uniform(0.5, 1.5, (B, spec.n_edges)).astype(np.float32))


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _port(model, tcfg, structure, arrays, fn=tff.fused_tgt_forward_multi):
    with torch.no_grad():
        return fn(model, tcfg, structure,
                  *(torch.from_numpy(a) for a in arrays),
                  operands=tff.prepare_fused_multi(model, tcfg)).numpy()


@pytest.mark.parametrize("d,nb", WIDTHS)
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_plain_k3_matches_pallas_interpret(structure, d, nb):
    jcfg, tcfg, params, model = _models(d, nb)
    arrays = _inputs(structure, seed=2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jff.fused_tgt_forward_multi(
            params, jcfg, structure, *map(jnp.asarray, arrays), block=8,
            interpret=True))
    got = _port(model, tcfg, structure, arrays,
                tff.fused_tgt_forward_multi_reference)
    assert got.shape == want.shape == (20, d)
    assert _rel(got, want) <= 1e-4, (structure, _rel(got, want))


@pytest.mark.parametrize("seed", [3, 7, 11])
@pytest.mark.parametrize("d,nb", WIDTHS)
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_plain_k3_matches_pallas_interpret_seed_sweep(structure, d, nb,
                                                      seed):
    jcfg, tcfg, params, model = _models(d, nb)
    arrays = _inputs(structure, B=40, seed=seed)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jff.fused_tgt_forward_multi(
            params, jcfg, structure, *map(jnp.asarray, arrays), block=8,
            interpret=True))
    got = _port(model, tcfg, structure, arrays,
                tff.fused_tgt_forward_multi_reference)
    rows = np.abs(got - want).max(axis=1) / (np.abs(want).max() + 1e-12)
    assert rows.max() <= 2e-3, (structure, rows.max())
    assert (rows > 1e-4).mean() <= 0.1, (structure, np.sort(rows)[-5:])


@pytest.mark.parametrize("d,nb", WIDTHS)
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_plain_k3_matches_jax_f32(structure, d, nb):
    jcfg, tcfg, params, model = _models(d, nb)
    arrays = _inputs(structure, seed=1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.encode_dense_multi(
            params, jcfg, structure, *map(jnp.asarray, arrays)))
    got = _port(model, tcfg, structure, arrays,
                tff.fused_tgt_forward_multi_reference)
    assert _rel(got, want) <= 3e-2, (structure, _rel(got, want))


def _refusal(kind):
    """(jax cfg, port cfg, params, model, structure) that JAX refuses."""
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=16,
              n_layers=3, num_bases=4)
    structure = "2-chain"
    if kind == "full_weight":
        kw["num_bases"] = None
    elif kind == "readout":
        kw["readout"] = "sum"
    elif kind == "too_many_modes":
        kw["n_modes"] = 130  # > d_pad = 128
    elif kind == "unpacked_vars":
        kw["n_modes"] = 72  # 3-chain: 2 variable slots x 72 > 128
        structure = "3-chain"
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(17), jcfg)
    model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, model, structure


@pytest.mark.parametrize("kind", ["full_weight", "readout", "too_many_modes",
                                  "unpacked_vars"])
def test_k3_raises_where_jax_raises(kind):
    jcfg, tcfg, params, model, structure = _refusal(kind)
    spec = STRUCTURES[structure]
    B = 8
    arrays = (np.zeros((B, spec.n_nodes), np.int32),
              np.zeros((B, spec.n_nodes), np.int32),
              np.zeros((B, spec.n_edges), np.int32),
              np.ones((B, spec.n_edges), np.float32))
    with pytest.raises(ValueError):
        jff.fused_tgt_forward_multi(params, jcfg, structure,
                                    *map(jnp.asarray, arrays), block=8,
                                    interpret=True)
    for fn in (tff.fused_tgt_forward_multi,
               tff.fused_tgt_forward_multi_reference):
        with pytest.raises(ValueError):
            _port(model, tcfg, structure, arrays, fn)
    assert not tm.multi_kernel_eligible(tcfg, structure)


def test_cpu_wrapper_runs_plain_version():
    _, tcfg, _, model = _models(16, 4)
    before = tff.fused_tgt_forward_multi.launches
    ops = tff.prepare_fused_multi(model, tcfg)
    for structure in STRUCTURE_NAMES:
        arrays = _inputs(structure, B=13, seed=2)
        with torch.no_grad():
            args = [torch.from_numpy(a) for a in arrays]
            a = tff.fused_tgt_forward_multi(model, tcfg, structure, *args,
                                            operands=ops)
            b = tff.fused_tgt_forward_multi_reference(model, tcfg, structure,
                                                      *args, operands=ops)
        assert torch.equal(a, b), structure
    assert tff.fused_tgt_forward_multi.launches == before


def _emulate_descriptor(ops, structure, tcfg, ne, nm, er, en):
    """Run the kernel's per-layer work in torch from the int32 plan
    descriptor alone (the layout ``csrc/fused_multi.cu`` parses), with
    the plain version's products and the kernel's order for everything
    else: x rows of the slots a layer multiplies, the self products,
    per edge ``msg`` over the bases ascending, then per out slot
    ``(self + bias) + sum of its edges' msg * norm`` in edge order."""
    desc = tff._descriptor(tcfg, structure)
    spec = STRUCTURES[structure]
    f32, d, dp, nb = torch.float32, ops.d, ops.d_pad, ops.n_bases
    B = ne.shape[0]
    steps, p = desc[0], 1
    x = {}  # slot -> [B, dp] bf16-valued f32 rows (layers >= 1)
    out = None
    for layer in range(steps):
        def take(width=1):
            """The next counted list of ``width``-tuples, flat."""
            nonlocal p
            n = desc[p]
            vals = desc[p + 1:p + 1 + n * width]
            p += 1 + n * width
            return vals
        a_slot, sp, ss = take(), take(), take()
        outs = take(2)
        edges = take(4)
        n_out, n_e = len(outs) // 2, len(edges) // 4
        rows = {}
        for s in a_slot:
            if layer == 0:
                r = ops.ent[ne[:, s].long().clamp(0, ops.ent.shape[0] - 1)]
                rows[s] = torch.nn.functional.pad(
                    r.to(torch.bfloat16).to(f32), (0, dp - d))
            else:
                rows[s] = x[s]
        selfs = [tff._ordered_matmul(rows[a_slot[i]],
                                     ops.w_self[layer].to(f32), d)
                 for i in ss]
        msgs = []
        for e in range(n_e):
            e_sp, e_out, j, e_slot = edges[4 * e:4 * e + 4]
            ce = ops.coeff[layer][er[:, j].long()]
            msg = None
            for b in range(nb):
                if e_sp < 0:
                    h = ops.tvar0[nm[:, e_slot].long(), b].to(f32)
                else:
                    w = ops.vw[layer][:, b * dp:(b + 1) * dp].to(f32)
                    h = tff._ordered_matmul(rows[a_slot[sp[e_sp]]], w, d)
                msg = ce[:, b:b + 1] * h if msg is None else \
                    msg + ce[:, b:b + 1] * h
            msgs.append((e_out, msg * en[:, j:j + 1]))
        y = {}
        for o in range(n_out):
            s, self_i = outs[2 * o], outs[2 * o + 1]
            v = (selfs[self_i] if self_i >= 0
                 else ops.tself0[nm[:, s].long()].to(f32)) + ops.bias[layer]
            acc = None
            for e_out, m in msgs:
                if e_out == o:
                    acc = m if acc is None else acc + m
            y[s] = v if acc is None else v + acc
        if layer == steps - 1:
            assert [outs[0]] == [spec.target_slot] and n_out == 1
            out = y[outs[0]][:, :d]
        else:
            x = {s: torch.relu(v).to(torch.bfloat16).to(f32)
                 for s, v in y.items()}
    assert p == len(desc)
    return out


@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_descriptor_drives_the_same_function(structure):
    _, tcfg, _, model = _models(16, 4)
    ops = tff.prepare_fused_multi(model, tcfg)
    args = [torch.from_numpy(a) for a in _inputs(structure, B=9, seed=3)]
    with torch.no_grad():
        want = tff.fused_tgt_forward_multi_reference(model, tcfg, structure,
                                                     *args, operands=ops)
        got = _emulate_descriptor(ops, structure, tcfg, *args)
    assert torch.equal(got, want), structure


def _k3_gate_case(d, nb, structure, B, queries):
    """The reordering emulation of K3 (products summed exactly, then
    rounded once; activations kept) must pass ``multi_gate`` against
    the ordered plain version, and both controls, on each of
    ``queries``, must fail it."""
    _, tcfg, _, model = _models(d, nb)
    ops = tff.prepare_fused_multi(model, tcfg)
    args = [torch.from_numpy(a) for a in _inputs(structure, B=B, seed=5)]
    with torch.no_grad():
        want = tff.fused_tgt_forward_multi_reference(
            model, tcfg, structure, *args, operands=ops)
        emu, acts = tff.fused_tgt_forward_multi_layers(
            model, tcfg, structure, *args, operands=ops,
            mm=tff._reordered_matmul)
        gate = tff.multi_gate(tcfg, structure, ops, args, emu, acts)
        assert gate["ok"], (structure, gate)
        assert gate["steps"] <= 1 and gate["last"] <= 1e-6, gate
        for q in queries:
            for name, o2, ne, er in tff.multi_gate_controls(
                    tcfg, structure, ops, args[0], args[2], q):
                ctl = tff.multi_gate(tcfg, structure, o2,
                                     (ne, args[1], er, args[3]), emu, acts)
                assert not ctl["ok"], (structure, name, q, ctl)
    return want, emu


@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_k3_gate_holds_reordering_and_fails_controls(structure):
    """d = 128, 16 bases, B = 1,000: the plain K3 with another sum order
    inside its products lies within ``multi_gate`` of the ordered plain
    version (``tools/k3_probe.py emulate`` holds the same over seeds and
    the card tests' widths); both negative controls, on query 0, fail
    it."""
    want, emu = _k3_gate_case(128, 16, structure, 1000, (0,))
    assert not torch.equal(emu, want)  # the reordering does move bits


@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_k3_gate_fails_controls_on_ordinary_queries_at_narrow_width(
        structure):
    """d = 16, 4 bases, B = 60: the gate passes the reordering and sees
    both controls on the first, a middle and the last query (the layer
    check needs no query whose row is large)."""
    _k3_gate_case(16, 4, structure, 60, (0, 30, 59))


def test_k3_layer_figures_count_bf16_steps():
    """One layer's figures: a one-step flip is one step and one moved
    element; a ReLU flip next to 0 counts no step; two steps are two; a
    one-step error everywhere moves every element."""
    want = torch.tensor([[0.0, 1.0, 3.0, 0.5], [2.0, 0.25, 0.0, 1.5]])
    up = (want.to(torch.bfloat16).view(torch.int16) + 1).view(
        torch.bfloat16).float()
    flip = want.clone()
    flip[0, 1] = up[0, 1]
    assert tff._layer_figures(want, want) == (0.0, 0)
    assert tff._layer_figures(flip, want) == (1.0, 1)
    relu = want.clone()
    relu[0, 0] = 1e-6  # y ~0: the plain version masked it, the kernel not
    assert tff._layer_figures(relu, want) == (0.0, 1)
    two = want.clone()
    two[1, 3] = (up[1, 3].to(torch.bfloat16).view(torch.int16) + 1).view(
        torch.bfloat16).float()
    assert tff._layer_figures(two, want) == (2.0, 1)
    nonzero = want != 0
    assert tff._layer_figures(torch.where(nonzero, up, want), want) == (
        1.0, int(nonzero.sum()))


def test_cpu_layers_wrapper_runs_plain_version():
    """On CPU tensors ``fused_tgt_forward_multi_layers`` is the plain
    version with its activations: the same output, and for every layer
    after the first the bf16 rows each output slot feeds the next."""
    _, tcfg, _, model = _models(16, 4)
    ops = tff.prepare_fused_multi(model, tcfg)
    before = tff.fused_tgt_forward_multi.launches
    for structure in STRUCTURE_NAMES:
        args = [torch.from_numpy(a) for a in _inputs(structure, 11, seed=4)]
        _, steps, plan, _, _ = tff._plan(tcfg, structure)
        with torch.no_grad():
            out, acts = tff.fused_tgt_forward_multi_layers(
                model, tcfg, structure, *args, operands=ops)
            want = tff.fused_tgt_forward_multi_reference(
                model, tcfg, structure, *args, operands=ops)
        assert torch.equal(out, want), structure
        assert sorted(acts) == list(range(1, steps)), structure
        for li, layer in acts.items():
            assert sorted(layer) == sorted(plan[li - 1][1]), structure
            for x in layer.values():
                assert x.shape == (11, ops.d_pad)
                assert torch.equal(x, x.to(torch.bfloat16).float())
                assert bool((x >= 0).all())
    assert tff.fused_tgt_forward_multi.launches == before