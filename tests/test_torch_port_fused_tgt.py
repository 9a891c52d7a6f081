"""K1 and K2 in the PyTorch port (``mpqe_tpu_torch/ops/fused_fwd.py``)
against the JAX package's Pallas kernels ``fused_tgt_forward`` and
``fused_tgt_backward``, run here in interpret mode with ``block=8`` (B = 20
and 40 exercise the row padding).  Inputs come from numpy with a seed,
parameters from the JAX ``init_mpqe`` (biases N(0, 0.1)), carried across
with ``model_from_numpy``.

Tolerances (max|diff| / max|ref|, per output leaf for K2):
* plain K1/K2 vs the Pallas kernels: 1e-4.  Same function and rounding
  points; only the f32 sum order inside the products differs (last-bit
  noise, measured <= 1.1e-6 on the fixed inputs here).  That noise can
  round an inter-layer activation to the neighbouring bf16 value (a
  flip), which moves that query's output row, and the gradient terms of
  that query.  The fixed inputs of the first tests have no flip.  The
  seed sweep holds a flip's shape instead: forward rows as for K3 (every
  row <= 2e-3, at most 1 in 10 beyond 1e-4); per gradient leaf at most
  1 element in 10 beyond 1e-4 and all within 2e-2, where a wrong formula
  moves most elements.
* plain K2 with the f32 wire (no bf16 rounding anywhere) vs the XLA VJP
  of ``encode_dense`` at HIGHEST: 1e-4 per leaf, as the reference's
  ``test_fused_pallas_backward_f32_wire_structurally_exact`` holds its
  own kernel: the reverse sweep and the weight-assembly transpose are
  exact, so only f32 sum order remains.
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

N_ENT, N_MODES, N_RELS, D = 50, 3, 9, 16
KINDS = {"basis": 4, "full": None}
_CACHE = {}


def _models(nb, n_modes=N_MODES):
    key = (nb, n_modes)
    if key not in _CACHE:
        kw = dict(n_entities=N_ENT, n_modes=n_modes, n_rels=N_RELS,
                  embed_dim=D, n_layers=3, num_bases=nb)
        jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
        params = jm.init_mpqe(jax.random.PRNGKey(1 + (nb or 0)), jcfg)
        rng = np.random.default_rng(n_modes)
        for lp in params["layers"]:
            lp["bias"] = jnp.asarray(
                0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
        model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
        _CACHE[key] = (jcfg, tcfg, params, model)
    return _CACHE[key]


def _inputs(structure, B=20, seed=0, n_modes=N_MODES):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, n_modes, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_RELS, (spec.n_edges,)).astype(np.int32),
            rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _jax_leaves(dp, den):
    """{port parameter name: array} of a JAX parameter cotangent."""
    out = {"emb.ent": dp["emb"]["ent"], "emb.var": dp["emb"]["var"],
           "edge_norm": den}
    for i, lp in enumerate(dp["layers"]):
        for k, v in lp.items():
            out[f"layers.{i}.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _port_leaves(dp, den):
    out = {k: v.detach().numpy() for k, v in dp.items()}
    out["edge_norm"] = den.detach().numpy()
    return out


def _both(jcfg, tcfg, params, model, structure, arrays, **port_kw):
    """(JAX forward, port forward, JAX grads, port grads) on the same
    arrays, the Pallas kernels in interpret mode, the port's plain
    versions."""
    ne, nm, er, en, g = arrays
    jargs = [jnp.asarray(a) for a in (ne, nm, er, en)]
    targs = [torch.from_numpy(a) for a in (ne, nm, er, en)]
    jf = np.asarray(jff.fused_tgt_forward(params, jcfg, structure, *jargs,
                                          block=8, interpret=True))
    tf = tff.fused_tgt_forward_reference(model, tcfg, structure,
                                         *targs).numpy()
    dpj, denj, _ = jff.fused_tgt_backward(params, jcfg, structure, *jargs,
                                          None, jnp.asarray(g), block=8,
                                          interpret=True)
    dpt, dent, _ = tff.fused_tgt_backward_reference(
        model, tcfg, structure, *targs, None, torch.from_numpy(g), **port_kw)
    return jf, tf, _jax_leaves(dpj, denj), _port_leaves(dpt, dent)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_plain_k1_k2_match_pallas_interpret(structure, kind):
    jcfg, tcfg, params, model = _models(KINDS[kind])
    jf, tf, jg, tg = _both(jcfg, tcfg, params, model, structure,
                           _inputs(structure, seed=0))
    assert tf.shape == jf.shape == (20, D)
    assert _rel(tf, jf) <= 1e-4, (structure, _rel(tf, jf))
    assert set(tg) == set(jg)
    for name, want in jg.items():
        if np.abs(want).max() > 0:
            assert _rel(tg[name], want) <= 1e-4, (structure, name,
                                                  _rel(tg[name], want))
        else:
            assert not np.abs(tg[name]).any(), (structure, name)


@pytest.mark.parametrize("seed", [3, 7])
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_plain_k1_k2_match_pallas_interpret_seed_sweep(structure, seed):
    jcfg, tcfg, params, model = _models(KINDS["basis"])
    jf, tf, jg, tg = _both(jcfg, tcfg, params, model, structure,
                           _inputs(structure, B=40, seed=seed))
    rows = np.abs(tf - jf).max(axis=1) / (np.abs(jf).max() + 1e-12)
    assert rows.max() <= 2e-3, (structure, rows.max())
    assert (rows > 1e-4).mean() <= 0.1, (structure, np.sort(rows)[-5:])
    for name, want in jg.items():
        scale = np.abs(want).max()
        if scale == 0:
            continue
        err = np.abs(tg[name] - want) / scale
        assert err.max() <= 2e-2, (structure, name, err.max())
        assert (err > 1e-4).mean() <= 0.1, (structure, name,
                                             (err > 1e-4).mean())


def test_plain_k1_k2_unpacked_variable_layout():
    # 2 variable slots x round_up(72, 8) > 128: one one-hot block per
    # variable slot (the reference's fallback layout)
    jcfg, tcfg, params, model = _models(KINDS["basis"], n_modes=72)
    structure = "3-chain"
    jf, tf, jg, tg = _both(jcfg, tcfg, params, model, structure,
                           _inputs(structure, seed=5, n_modes=72))
    assert _rel(tf, jf) <= 1e-4
    for name, want in jg.items():
        if np.abs(want).max() > 0:
            assert _rel(tg[name], want) <= 1e-4, name


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_k2_f32_wire_structurally_exact(kind):
    jcfg, tcfg, params, model = _models(KINDS[kind])
    for structure in STRUCTURE_NAMES:
        ne, nm, er, en, g = _inputs(structure, seed=12)
        with jax.default_matmul_precision("highest"):
            _, vjp = jax.vjp(lambda p, e: jm.encode_dense(
                p, jcfg, structure, jnp.asarray(ne), jnp.asarray(nm),
                jnp.asarray(er), e), params, jnp.asarray(en))
            want = _jax_leaves(*vjp(jnp.asarray(g)))
        dpt, dent, _ = tff.fused_tgt_backward_reference(
            model, tcfg, structure, *map(torch.from_numpy, (ne, nm, er, en)),
            None, torch.from_numpy(g), f32_wire=True)
        got = _port_leaves(dpt, dent)
        for name, w in want.items():
            if np.abs(w).max() > 0:
                assert _rel(got[name], w) <= 1e-4, (structure, name,
                                                    _rel(got[name], w))


@pytest.mark.parametrize("kind", list(KINDS))
def test_layer_matrices_match_jax(kind):
    jcfg, tcfg, params, model = _models(KINDS[kind])
    for structure in STRUCTURE_NAMES:
        ne, nm, er, en, _ = _inputs(structure, seed=4)
        spec, steps, plan, a_slots, v_slots = jff._plan(jcfg, structure)
        jW, jb = jff._layer_matrices(params, jcfg, spec, steps, plan, a_slots,
                                     v_slots, jnp.asarray(er),
                                     jnp.asarray(en), 128)
        with torch.no_grad():
            tW, tb = tff._layer_matrices(model, tcfg, spec, steps, plan,
                                         a_slots, v_slots,
                                         torch.from_numpy(er),
                                         torch.from_numpy(en), 128)
        assert len(jW) == len(tW) == steps
        for a, b in zip(jW, tW):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a)[0])
            assert not np.asarray(a)[1:].any()


def _refusal(kind):
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=D,
              n_layers=3, num_bases=4)
    if kind == "readout":
        kw["readout"] = "sum"
    else:
        kw["n_modes"] = 130  # > d_pad = 128
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


@pytest.mark.parametrize("kind", ["readout", "too_many_modes"])
def test_k1_k2_raise_where_jax_raises(kind):
    jcfg, tcfg, params, model = _refusal(kind)
    ne, nm, er, en, g = _inputs("2-chain", B=8)
    with pytest.raises(ValueError):
        jff.fused_tgt_forward(params, jcfg, "2-chain",
                              *map(jnp.asarray, (ne, nm, er, en)), block=8,
                              interpret=True)
    targs = [torch.from_numpy(a) for a in (ne, nm, er, en)]
    for fn in (tff.fused_tgt_forward, tff.fused_tgt_forward_reference):
        with pytest.raises(ValueError):
            fn(model, tcfg, "2-chain", *targs)
    with pytest.raises(ValueError):
        tff.fused_tgt_backward(model, tcfg, "2-chain", *targs, None,
                               torch.from_numpy(g))


def test_cpu_wrappers_run_plain_versions():
    _, tcfg, _, model = _models(KINDS["basis"])
    f0 = tff.fused_tgt_forward.launches
    b0 = tff.fused_tgt_backward.launches
    for structure in STRUCTURE_NAMES:
        ne, nm, er, en, g = _inputs(structure, B=13, seed=2)
        targs = [torch.from_numpy(a) for a in (ne, nm, er, en)]
        with torch.no_grad():
            a = tff.fused_tgt_forward(model, tcfg, structure, *targs)
        b = tff.fused_tgt_forward_reference(model, tcfg, structure, *targs)
        assert torch.equal(a, b), structure
        da, dena, _ = tff.fused_tgt_backward(model, tcfg, structure, *targs,
                                             None, torch.from_numpy(g))
        db, denb, _ = tff.fused_tgt_backward_reference(
            model, tcfg, structure, *targs, None, torch.from_numpy(g))
        assert torch.equal(dena, denb)
        for name in da:
            assert torch.equal(da[name], db[name]), (structure, name)
    assert tff.fused_tgt_forward.launches == f0
    assert tff.fused_tgt_backward.launches == b0


def _emulate_k2_passes(x0, ws, bs, g, n_a, d, d_pad, tq):
    """K2's three passes as the CUDA source runs them: pass A per row tile
    of ``tq`` rows (recompute, walk back, write dA and the scratch
    activations / cotangents), pass B per row partition into the flat
    ``[P][T]`` partial buffer (per layer dW then db), pass C in partition
    order; returns (dA, flat [T])."""
    f32, bf16 = torch.float32, torch.bfloat16
    B = x0.shape[0]
    L = len(ws)
    ks = [w.shape[0] for w in ws]
    ns = [w.shape[1] for w in ws]
    xg = [x0.to(f32)] + [torch.zeros((B, k)) for k in ks[1:]]
    gg = [torch.zeros((B, n)) for n in ns]
    da = torch.zeros((B, n_a, d))
    for q0 in range(0, B, tq):
        rows = slice(q0, min(B, q0 + tq))
        x, ys = xg[0][rows], []
        for li in range(L - 1):
            y = tff._ordered_matmul(x, ws[li].to(f32), ks[li]) + bs[li]
            ys.append(y)
            x = torch.relu(y).to(bf16).to(f32)
            xg[li + 1][rows] = x
        gl = torch.nn.functional.pad(g[rows], (0, ns[-1] - d))
        gg[L - 1][rows] = gl
        for li in range(L - 1, -1, -1):
            gb = gl.to(bf16).to(f32)
            wt = ws[li].to(f32).t()
            if li > 0:
                dx = tff._ordered_matmul(gb, wt, ns[li])
                gl = torch.where(ys[li - 1] > 0, dx, dx.new_zeros(()))
                gg[li - 1][rows] = gl
            else:
                dx = tff._ordered_matmul(gb, wt[:, :n_a * d_pad], ns[li])
                da[rows] = dx.view(-1, n_a, d_pad)[:, :, :d]
    R = tff._partition_rows(B)
    P = -(-B // R)
    T = sum(k * n + n for k, n in zip(ks, ns))
    partial = torch.zeros((P, T))
    for p in range(P):
        off = 0
        for li in range(L):
            k, n = ks[li], ns[li]
            acc_w, acc_b = torch.zeros((k, n)), torch.zeros((n,))
            for r in range(p * R, min(B, (p + 1) * R)):
                gr = gg[li][r]
                acc_w = acc_w + xg[li][r][:, None] * gr.to(bf16).to(f32)[None]
                acc_b = acc_b + gr
            partial[p, off:off + k * n] = acc_w.flatten()
            partial[p, off + k * n:off + k * n + n] = acc_b
            off += k * n + n
    flat = torch.zeros((T,))
    for p in range(P):
        flat = flat + partial[p]
    return da, flat


@pytest.mark.parametrize("structure", ["3-chain", "3-inter_chain", "1-chain"])
def test_k2_pass_emulation_matches_plain_version(structure):
    """The kernel's tiling, scratch and flat [dW_l, db_l] layout compute
    the plain version's values bit for bit (4-row and 16-row tiles)."""
    _, tcfg, _, model = _models(KINDS["basis"])
    ne, nm, er, en, g = _inputs(structure, B=37, seed=9)
    targs = [torch.from_numpy(a) for a in (ne, nm, er, en)]
    with torch.no_grad():
        v_slots, d_pad, cols, Ws, bs = tff._assemble(model, tcfg, structure,
                                                     *targs, None)
        x0 = tff._layer0_operand(cols, targs[1], v_slots, tcfg, d_pad)
        ws = [W.to(torch.bfloat16) for W in Ws]
        want = tff._chain_backward_plain(x0, ws, bs, torch.from_numpy(g),
                                         len(cols), D, d_pad)
        for tq in (4, 16):
            da, flat = _emulate_k2_passes(x0, ws, bs, torch.from_numpy(g),
                                          len(cols), D, d_pad, tq)
            assert torch.equal(da, want[0])
            off = 0
            for dw, db in zip(want[1], want[2]):
                k, n = dw.shape
                assert torch.equal(flat[off:off + k * n].view(k, n), dw)
                assert torch.equal(flat[off + k * n:off + k * n + n], db)
                off += k * n + n
