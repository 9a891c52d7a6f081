"""Models at ``cfg.dtype = bfloat16`` in the PyTorch port against the JAX
package at the same dtype: the dense encoders, the plain K1 / K2 / K3
(the Pallas kernels in interpret mode, ``block=8``), the losses and
their gradients, the optimizer against optax, the training loop and the
CLIs, ``convert.py``'s bf16 leaves, the GQE leaves, the sparse and halo
routes running a bf16 model, and K2's parameter-gradient limit at the
card's width.  Inputs come from numpy with a seed, parameters from the
JAX ``init_mpqe`` / ``init_gqe`` at bf16 (MPQE biases N(0, 0.1), rounded
to bf16), carried across bit for bit by ``model_from_numpy``.

Tolerances (max|diff| / max|ref| unless said otherwise):
* the bf16 encoders (``encode_dense`` for every readout, both layer
  kinds; ``encode_dense_multi``), and the plain K1 / K3 against the
  Pallas kernels at bf16: 1e-2.  Both sides take f32 products of the
  same bf16 values and round to bf16 at the same points; only the f32
  sum order may differ, and a last-bit difference there can round a
  bf16 value to its neighbour (one step, 2^-8 of it), which the next
  layers carry.  Measured here: 0 (bit-equal) for the encoders and K1,
  2.1e-6 for K3.  K1 against the bf16 ``encode_dense``: the reference's
  own bound, 3e-2 (``tests/test_pallas_fused_fwd.py:360``; measured
  5.6e-3, the same as the Pallas kernel's own).
* gradients, per leaf in mean|diff| / mean|ref|, every leaf bf16: 2e-3.
  The dense loss and the K1 loss with the recompute backward are
  bit-equal to JAX's here (measured 0); the plain K2 against the Pallas
  K2 measured 8.6e-6 (max form 1.2e-4), and the K1/K2 loss's gradients
  2.1e-4 (max form 2.3e-3): their f32 sums differ in order before the
  bf16 rounding, and autograd sums the bf16 table gradients in its own
  order.
* losses: 3e-3 relative (measured 3.0e-4, the K1/K2 route).
* the optimizer: bit-equal to optax on bf16 parameters for adam, adamw
  and sgd, with a schedule; with the global-norm clip, every element
  within one bf16 step (the clip's norm sums the squares in another
  order).
* GQE, whose every operation runs in bf16 on both sides: against the
  f32 gradient of the same bf16 values, no worse than twice JAX's own
  bf16 error plus 1e-3 (its test says why).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpqe_tpu.models import gqe as jgqe
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import pallas_fused_fwd as jff
from mpqe_tpu.queries import STRUCTURES
from mpqe_tpu.train import loop as jloop
from mpqe_tpu_torch import convert
from mpqe_tpu_torch.models import gqe as tgqe
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import fused_fwd as tff
from mpqe_tpu_torch.train import loop as tloop

BF16 = torch.bfloat16
N_ENT, N_MODES, N_RELS, D = 50, 3, 9, 16
STRUCTS = ("3-chain_inter", "2-inter", "3-chain")
TOL_ENC = 1e-2
TOL_REF = 3e-2
TOL_GRAD = 2e-3
TOL_LOSS = 3e-3
_CACHE = {}


def _models(nb=4, readout="tgt"):
    key = (nb, readout)
    if key not in _CACHE:
        kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
                  embed_dim=D, n_layers=3, num_bases=nb, readout=readout)
        jcfg = jm.MPQEConfig(**kw, dtype=jnp.bfloat16)
        tcfg = tm.MPQEConfig(**kw, dtype=BF16)
        params = jm.init_mpqe(jax.random.PRNGKey(3 + (nb or 0)), jcfg)
        rng = np.random.default_rng(1)
        for lp in params["layers"]:
            lp["bias"] = jnp.asarray(0.1 * rng.normal(
                size=lp["bias"].shape), jnp.bfloat16)
        model = convert.model_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, "cpu")
        _CACHE[key] = (jcfg, tcfg, params, model)
    return _CACHE[key]


def _inputs(structure, B=20, seed=0, per_query=False):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    shape = (B, spec.n_edges) if per_query else (spec.n_edges,)
    return (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_RELS, shape).astype(np.int32),
            rng.uniform(0.5, 1.5, shape).astype(np.float32))


def _f(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _f(got), _f(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _mean_rel(got, want):
    got, want = _f(got), _f(want)
    return float(np.abs(got - want).mean() / (np.abs(want).mean() + 1e-30))


def _jax_grads(dp):
    """{port parameter name: array} of a JAX MPQE parameter cotangent."""
    out = {"emb.ent": dp["emb"]["ent"], "emb.var": dp["emb"]["var"]}
    for i, lp in enumerate(dp["layers"]):
        for k, v in lp.items():
            out[f"layers.{i}.{k}"] = v
    for k, v in dp.get("readout", {}).items():
        out[f"readout.{k}"] = v
    return out


def _check_grads(tgrads, jgrads):
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        got = tgrads[name]
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16, name
        if np.abs(_f(want)).max() == 0:
            assert not np.abs(_f(got)).any(), name
            continue
        assert _mean_rel(got, want) <= TOL_GRAD, (name,
                                                  _mean_rel(got, want))


# ------------------------------------------------------------ convert
def test_convert_bf16_round_trip_bit_for_bit():
    _, tcfg, params, model = _models()
    for p in model.parameters():
        assert p.dtype == BF16
    back = convert.model_to_numpy(model)
    jleaves = jax.tree.leaves(params)
    tleaves = jax.tree.leaves(back)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert t.dtype == np.uint16
        np.testing.assert_array_equal(np.asarray(j).view(np.uint16), t)
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(t.view(jnp.bfloat16))).view(np.uint16),
            np.asarray(j).view(np.uint16))
    # one layer dict, and an f32 model loaded from bf16 arrays (exact)
    layer = convert.layer_from_numpy(jax.tree.map(np.asarray,
                                                  params["layers"][0]))
    assert layer.basis.dtype == BF16
    assert torch.equal(layer.basis.view(torch.int16),
                       model.layers[0].basis.view(torch.int16))
    m32 = convert.model_from_numpy(jax.tree.map(np.asarray, params),
                                   dataclasses.replace(tcfg,
                                                       dtype=torch.float32))
    assert torch.equal(m32.emb.ent, model.emb.ent.float())


def test_model_dtypes_and_refusal():
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=D)
    cfg = tm.MPQEConfig(**kw, num_bases=4, readout="mlp", dtype=BF16)
    model = tm.init_mpqe(torch.Generator().manual_seed(0), cfg)
    jp = jm.init_mpqe(jax.random.PRNGKey(0), jm.MPQEConfig(
        **kw, num_bases=4, readout="mlp", dtype=jnp.bfloat16))
    tleaves = convert.model_to_numpy(model)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, tleaves)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jp))
    for p in model.parameters():
        assert p.dtype == BF16
    assert all(p.dtype == BF16 for p in tm.MPQE(cfg).parameters())
    with pytest.raises(ValueError, match="model dtype"):
        tm.MPQEConfig(**kw, dtype=torch.float16)


# ------------------------------------------------------------ encoders
@pytest.mark.parametrize("readout", ["tgt", "sum", "max", "concat", "mlp"])
@pytest.mark.parametrize("nb", [4, None])
def test_encode_dense_bf16_matches_jax(nb, readout):
    jcfg, tcfg, params, model = _models(nb, readout)
    for structure in STRUCTS:
        ne, nm, er, en = _inputs(structure)
        want = jm.encode_dense(params, jcfg, structure, *map(jnp.asarray,
                                                             (ne, nm, er,
                                                              en)))
        with torch.no_grad():
            got = tm.encode_dense(model, tcfg, structure,
                                  *map(torch.from_numpy, (ne, nm, er, en)))
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        assert _rel(got, want) <= TOL_ENC, (structure, _rel(got, want))


@pytest.mark.parametrize("nb", [4, None])
def test_encode_dense_multi_bf16_matches_jax(nb):
    jcfg, tcfg, params, model = _models(nb)
    for structure in STRUCTURES:
        arrays = _inputs(structure, seed=2, per_query=True)
        want = jm.encode_dense_multi(params, jcfg, structure,
                                     *map(jnp.asarray, arrays))
        with torch.no_grad():
            got = tm.encode_dense_multi(model, tcfg, structure,
                                        *map(torch.from_numpy, arrays))
        assert got.dtype == BF16
        assert _rel(got, want) <= TOL_ENC, (structure, _rel(got, want))


# ------------------------------------------------- plain K1 / K2 / K3
@pytest.mark.parametrize("structure", STRUCTS)
def test_plain_k1_bf16_matches_pallas_and_encoder(structure):
    # the counterpart of tests/test_pallas_fused_fwd.py:360
    jcfg, tcfg, params, model = _models()
    ne, nm, er, en = _inputs(structure)
    jargs = list(map(jnp.asarray, (ne, nm, er, en)))
    targs = list(map(torch.from_numpy, (ne, nm, er, en)))
    jk = jm.encode_dense_fused(params, jcfg, structure, *jargs, block=8,
                               interpret=True)
    jx = jm.encode_dense(params, jcfg, structure, *jargs)
    with torch.no_grad():
        tk = tm.encode_dense_fused(model, tcfg, structure, *targs)
        plain = tff.fused_tgt_forward_reference(model, tcfg, structure,
                                                *targs)
        f32_out = tff.fused_tgt_forward_reference(
            model, dataclasses.replace(tcfg, dtype=torch.float32),
            structure, *targs)
    assert tk.dtype == plain.dtype == BF16 and jk.dtype == jnp.bfloat16
    assert torch.equal(tk.view(torch.int16), plain.view(torch.int16))
    # the bf16 store is the rounding of the f32 output, bit for bit
    assert torch.equal(plain.view(torch.int16),
                       f32_out.to(BF16).view(torch.int16))
    assert _rel(tk, jk) <= TOL_ENC, _rel(tk, jk)
    assert _rel(tk, jx) <= TOL_REF, _rel(tk, jx)


@pytest.mark.parametrize("structure", STRUCTS)
def test_plain_k2_bf16_matches_pallas(structure):
    jcfg, tcfg, params, model = _models()
    ne, nm, er, en = _inputs(structure, seed=4)
    g = np.random.default_rng(5).normal(size=(20, D)).astype(np.float32)
    dpj, _, _ = jff.fused_tgt_backward(
        params, jcfg, structure, *map(jnp.asarray, (ne, nm, er, en)), None,
        jnp.asarray(g, jnp.bfloat16).astype(jnp.float32), block=8,
        interpret=True)
    dpt, _, _ = tff.fused_tgt_backward_reference(
        model, tcfg, structure, *map(torch.from_numpy, (ne, nm, er, en)),
        None, torch.from_numpy(g).to(BF16))
    _check_grads(dpt, _jax_grads(dpj))


@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_k2_param_grad_limit_and_its_control(structure):
    """``PARAM_GRAD_MEAN_BY_DEPTH`` at the card's width (d = 128, 16
    bases, a bf16 model, B = 512; ``tools/tgt_probe.py emulate`` runs 4
    seeds and B = 1,000 too): K2's chain in another sum order, mapped
    through the weight assembly, stays within it; the control fails it
    and passes the depth tolerance it replaced."""
    from mpqe_tpu_torch.tools import tgt_probe

    cfg = tm.MPQEConfig(n_entities=5000, n_modes=4, n_rels=266,
                        embed_dim=128, n_layers=3, num_bases=16, dtype=BF16)
    model = tm.init_mpqe(torch.Generator().manual_seed(1), cfg)
    depth = tm.num_steps(cfg, structure)
    e, c = tgt_probe.param_figures(model, cfg, structure, 512, 1)
    assert e <= tff.PARAM_GRAD_MEAN_BY_DEPTH[depth], e
    assert tff.PARAM_GRAD_MEAN_BY_DEPTH[depth] < c <= {
        1: 3e-2, 2: 8e-2, 3: 2.5e-1}[depth], c


@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_plain_k3_bf16_matches_pallas(structure):
    jcfg, tcfg, params, model = _models()
    arrays = _inputs(structure, seed=6, per_query=True)
    want = jff.fused_tgt_forward_multi(params, jcfg, structure,
                                       *map(jnp.asarray, arrays), block=8,
                                       interpret=True)
    ops = tff.prepare_fused_multi(model, tcfg)
    assert ops.ent is not None and ops.ent.dtype == BF16
    with torch.no_grad():
        got = tff.fused_tgt_forward_multi(model, tcfg, structure,
                                          *map(torch.from_numpy, arrays),
                                          operands=ops)
        f32_out = tff.fused_tgt_forward_multi_reference(
            model, dataclasses.replace(tcfg, dtype=torch.float32), structure,
            *map(torch.from_numpy, arrays), operands=ops)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert torch.equal(got.view(torch.int16),
                       f32_out.to(BF16).view(torch.int16))
    assert _rel(got, want) <= TOL_ENC, _rel(got, want)


# ------------------------------------------------------ losses, grads
def _batch(structure, B=20, seed=8):
    ne, nm, er, en = _inputs(structure, B, seed)
    rng = np.random.default_rng(seed + 1)
    return (ne, nm, er, en,
            rng.integers(0, N_ENT, (B,)).astype(np.int32),
            rng.integers(0, N_ENT, (B, 3)).astype(np.int32),
            np.ones((B, 3), np.float32), np.ones((B,), np.float32))


@pytest.mark.parametrize("route", ["dense", "fused_fwd_xla",
                                   "fused_fwd_pallas"])
@pytest.mark.parametrize("structure", STRUCTS)
def test_bf16_loss_and_grads_match_jax(structure, route):
    """The port's bf16 loss and gradients against JAX's at bf16: the
    dense loss; K1/K2 (``fused_fwd_pallas``) against the reference's,
    its Pallas kernels in interpret mode.  The reference's
    ``backward="xla"`` route refuses bf16 (its vjp gets an f32 cotangent
    for a bf16 output); the port's recompute takes the cotangent in the
    output's dtype, and is held to that computation written out in JAX."""
    jcfg, tcfg, params, model = _models()
    arrays = _batch(structure)
    jargs = list(map(jnp.asarray, arrays))
    if route == "fused_fwd_xla":
        # the reference's route with the cotangent in the output's dtype:
        # K1's forward, the loss's cotangent of q pulled back through the
        # bf16 encode_dense, plus the candidate rows' own gradient
        q = jm.encode_dense_fused(params, jcfg, structure, *jargs[:4],
                                  block=8, interpret=True)
        jv, (g_rows, gq) = jax.value_and_grad(
            lambda p, q: jm.margin_loss_from_queries(p, jcfg, q,
                                                     *jargs[4:]),
            argnums=(0, 1))(params, q)
        _, vjp = jax.vjp(lambda p: jm.encode_dense(p, jcfg, structure,
                                                   *jargs[:4]), params)
        jg = jax.tree.map(jnp.add, g_rows, vjp(gq)[0])
    else:
        if route == "fused_fwd_pallas":
            def jloss(p):
                return jm.dense_batch_loss_kernel_fused_fwd(
                    p, jcfg, structure, *jargs, block=8, interpret=True,
                    backward="pallas", bwd_block=8)
        else:
            def jloss(p):
                return jm.dense_batch_loss(p, jcfg, structure, *jargs)
        jv, jg = jax.value_and_grad(jloss)(params)
    model.zero_grad(set_to_none=True)
    targs = list(map(torch.from_numpy, arrays))
    if route == "dense":
        loss = tm.dense_batch_loss(model, tcfg, structure, *targs)
    else:
        loss = tm.dense_batch_loss_kernel_fused_fwd(
            model, tcfg, structure, *targs,
            backward=route.rsplit("_", 1)[1])
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jv)) <= TOL_LOSS * abs(float(jv))
    tg = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in model.named_parameters()}
    _check_grads(tg, _jax_grads(jg))
    model.zero_grad(set_to_none=True)


# ----------------------------------------------------------- optimizer
def _optax_run(tc, p0, grads):
    opt = jloop.make_optimizer(tc)
    p = {"w": jnp.asarray(p0, jnp.bfloat16)}
    st = opt.init(p)
    out = []
    for g in grads:
        u, st = opt.update({"w": jnp.asarray(g, jnp.bfloat16)}, st, p)
        p = optax.apply_updates(p, u)
        out.append(_f(p["w"]))
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(weight_decay=1e-2), dict(optimizer="sgd"),
    dict(lr_schedule="warmup_cosine", warmup_steps=2),
    dict(grad_clip_norm=0.5)])
def test_bf16_optimizer_matches_optax(kw):
    rng = np.random.default_rng(0)
    p0 = (0.1 * rng.normal(size=(500,))).astype(np.float32)
    grads = [(rng.normal(size=(500,)) * 10 ** rng.uniform(-4, 0, 500))
             .astype(np.float32) for _ in range(6)]
    want = _optax_run(jloop.TrainConfig(lr=0.01, max_steps=8, **kw), p0,
                      grads)
    w = torch.nn.Parameter(torch.from_numpy(p0).to(BF16))
    opt = tloop.OptaxAdam([w], tloop.TrainConfig(lr=0.01, max_steps=8,
                                                 **kw))
    for g, ref in zip(grads, want):
        w.grad = torch.from_numpy(g).to(BF16)
        opt.step()
        got = _f(w)
        if kw.get("grad_clip_norm"):
            step = np.abs(ref) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(got - ref) <= step)
        else:
            np.testing.assert_array_equal(got, ref)
    if kw.get("optimizer") != "sgd":
        st = opt.state[w]
        assert st["mu"].dtype == st["nu"].dtype == BF16


# ------------------------------------------------------ training loop
def test_bf16_training_decreases_loss():
    # the counterpart of tests/test_bf16.py
    from mpqe_tpu_torch.data.sampler import QuerySampler, make_random_kg
    from mpqe_tpu_torch.queries import group_queries_by_formula
    from mpqe_tpu_torch.train import evaluation

    kg = make_random_kg(n_entities=100, n_modes=2, n_base_rels=3,
                        n_triples=200, seed=41)
    sampler = QuerySampler(kg, seed=1)
    train_q = group_queries_by_formula(
        sampler.sample_queries("1-chain", 200, n_neg=8))
    cfg = tm.MPQEConfig(n_entities=kg.n_entities, n_modes=kg.n_modes,
                        n_rels=kg.n_rels, embed_dim=32, n_layers=1,
                        readout="sum", dtype=BF16)
    tc = tloop.TrainConfig(lr=0.01, batch_size=64, n_neg=4, max_steps=150,
                           conv_tol=-1.0, val_every=10_000)
    state = tloop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   tc, device="cpu")
    assert state.model.emb.ent.dtype == BF16
    losses = []
    state = tloop.run_train(
        state, cfg, tc, train_q,
        log_fn=lambda r: losses.append(r["loss"]) if "loss" in r else None)
    assert np.mean(losses[-20:]) < 0.5 * np.mean(losses[:20])
    res = evaluation.evaluate(state.model, cfg, train_q, n_neg=8)
    assert res.macro_auc > 0.8
    for st in state.optimizer.state.values():
        assert st["mu"].dtype == st["nu"].dtype == BF16


def test_bf16_checkpoint_round_trip(tmp_path):
    from mpqe_tpu_torch.train import checkpoint as ckpt

    cfg = tm.MPQEConfig(n_entities=30, n_modes=2, n_rels=4, embed_dim=8,
                        n_layers=2, num_bases=2, dtype=BF16)
    tc = tloop.TrainConfig(lr=0.01)
    state = tloop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   tc, device="cpu")
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.step = 1
    path = ckpt.save_checkpoint(str(tmp_path), state)
    fresh = tloop.init_train_state(torch.Generator().manual_seed(1), cfg,
                                   tc, device="cpu")
    back = ckpt.restore_checkpoint(path, fresh)
    for (n, a), b in zip(state.model.named_parameters(),
                         back.model.parameters()):
        assert b.dtype == BF16 and torch.equal(a, b), n
    for a, b in zip(state.model.parameters(), back.model.parameters()):
        sa, sb = state.optimizer.state[a], back.optimizer.state[b]
        for k in ("mu", "nu"):
            assert sb[k].dtype == BF16 and torch.equal(sa[k], sb[k])


def test_train_bfloat16_cli_then_serve_and_evaluate(tmp_path, capsys):
    """The counterpart of ``tests/test_cli.py:263`` on both bf16 routes,
    then the run dir evaluated and served from each candidate table."""
    from mpqe_tpu_torch import evaluate as eval_cli
    from mpqe_tpu_torch import serve as serve_cli
    from mpqe_tpu_torch.train.__main__ import main

    common = ["--device", "cpu", "--data", "synthetic", "--embed_dim", "16",
              "--steps", "40", "--val_every", "30", "--batch_size", "32",
              "--n_neg", "4", "--syn_entities", "150", "--syn_triples",
              "400", "--syn_train_queries", "140", "--syn_val_queries",
              "35", "--dtype", "bfloat16"]
    for name, extra in (("dense", ["--n_layers", "1", "--readout", "sum"]),
                        ("fused", ["--num_bases", "4", "--kernel",
                                   "fused_fwd", "--fused_backward",
                                   "pallas"])):
        run_dir = str(tmp_path / name)
        state = main(common + extra + ["--run_dir", run_dir])
        assert state.step == 40
        assert all(p.dtype == BF16 for p in state.model.parameters())
        with open(os.path.join(run_dir, "model_config.json")) as f:
            assert json.load(f)["dtype"] == "torch.bfloat16"
        recs = [json.loads(ln) for ln in open(
            os.path.join(run_dir, "metrics.jsonl"))]
        vals = [r for r in recs if "val" in r]
        assert vals and all(np.isfinite(v["val"]["auc_macro"])
                            for v in vals)
    capsys.readouterr()
    run_dir = str(tmp_path / "fused")
    eval_cli.main(["--device", "cpu", "--run_dir", run_dir, "--ranking"])
    lines = capsys.readouterr().out.strip().splitlines()
    head = json.loads(lines[0])
    assert np.isfinite(head["auc_macro"]) and head["step"] == 40
    assert all(np.isfinite(json.loads(ln)["mrr"]) for ln in lines[1:])
    for td in ("float32", "bfloat16", "int8"):
        serve_cli.main(["--device", "cpu", "--run_dir", run_dir,
                        "--requests", "4", "--batch", "3",
                        "--table_dtype", td])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["table_dtype"] == td and out["checkpoint"].endswith(
            "step_40")
        assert out["table_bytes"] == 150 * 16 * {
            "float32": 4, "bfloat16": 2, "int8": 1}[td]
        assert np.isfinite(out["latency_ms_p50"])


def test_config_from_json_reads_the_jax_spelling(tmp_path):
    """``model_config.json`` as the JAX package writes it
    (``MetricsWriter.write_config(dataclasses.asdict(cfg))``)."""
    from mpqe_tpu.train.metrics import MetricsWriter
    from mpqe_tpu_torch.serve import config_from_json

    jcfg = jm.MPQEConfig(n_entities=10, n_modes=2, n_rels=4, embed_dim=8,
                         num_bases=2, dtype=jnp.bfloat16)
    w = MetricsWriter(str(tmp_path))
    w.write_config(dataclasses.asdict(jcfg), "model_config.json")
    w.close()
    with open(tmp_path / "model_config.json") as f:
        mc = json.load(f)
    assert "bfloat16" in mc["dtype"] and "torch" not in mc["dtype"]
    cfg = config_from_json(mc)
    assert cfg.dtype == BF16 and cfg.num_bases == 2
    gcfg = config_from_json({"n_entities": 10, "n_modes": 2, "n_rels": 4,
                             "embed_dim": 8, "decoder": "bilinear",
                             "intersection": "mean", "soft_and": False,
                             "dtype": mc["dtype"]})
    assert gcfg.dtype == BF16


# ------------------------------------------ the sparse routes at bf16
def test_sparse_and_halo_routes_refuse_bf16_before_any_work():
    """The sparse and halo routes once refused a bf16 model before any
    work; each now runs it: ``encode_sparse`` to f32 query vectors (no
    rounding between layers, as the reference's), the K5 and K6 encoders
    to bf16 ones, and the K5, K6 and halo losses to a finite f32 loss with
    every gradient in bf16 (held to JAX's in
    ``tests/test_torch_port_bf16_sparse.py``)."""
    from mpqe_tpu_torch.ops import template_layout as ttl
    from mpqe_tpu_torch.parallel import halo_train
    from mpqe_tpu_torch.parallel import mesh as tmesh

    _, tcfg, _, model = _models()
    s = "3-chain_inter"
    ne, nm, er, en, tgt, neg, nmask, qmask = map(torch.from_numpy,
                                                 _batch(s, B=16))
    view = tm._sparse_view_on_device(s, ne, nm)
    B = view[-1]
    ch = ttl.template_chunked(s, er, en, B, 8)
    lays = ttl.template_blocked_layouts(s, er, en, B, queries_per_block=8,
                                        chunk=8)
    with torch.no_grad():
        q = tm.encode_sparse(model, tcfg, s, *view[:3], ch["src"],
                             ch["dst"], er.repeat_interleave(B), ch["norm"],
                             *view[3:5], B)
        q5 = tm.encode_sparse_fused(model, tcfg, s, *view[:3], ch,
                                    *view[3:5], B)
        q6 = tm.encode_sparse_blocked(model, tcfg, s, *view[:3], lays,
                                      *view[3:5], B)
    assert q.dtype == torch.float32 and q5.dtype == q6.dtype == BF16
    for t in (q, q5, q6):
        assert t.shape == (B, D) and bool(torch.isfinite(t).all())
    batch = (ne, nm, er, en, tgt, neg, nmask, qmask)
    mesh = tmesh.make_mesh((2, 1), devices=["cpu"] * 2)
    for loss_fn in (
            lambda: tm.dense_batch_loss_kernel_fused(model, tcfg, s, *batch,
                                                     chunk=8),
            lambda: tm.dense_batch_loss_kernel_blocked(
                model, tcfg, s, *batch, queries_per_block=8, chunk=8),
            lambda: halo_train.halo_dense_batch_loss(model, tcfg, mesh,
                                                     "ring", s, *batch)):
        loss = loss_fn()
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        assert loss.dtype == torch.float32
        assert np.isfinite(float(loss.detach()))
        assert all(g is None or g.dtype == BF16 for g in grads)


# ----------------------------------------------------------------- GQE
GQE_DECODERS = ("bilinear", "transe", "distmult", "box", "bibox")


@pytest.mark.parametrize("decoder", GQE_DECODERS)
def test_gqe_bf16_leaves_match_jax_init(decoder):
    kw = dict(n_entities=40, n_modes=2, n_rels=6, embed_dim=8,
              decoder=decoder, intersection="deepsets",
              encoder="neighborhood", aggregator="pool")
    jp = jgqe.init_gqe(jax.random.PRNGKey(0),
                       jgqe.GQEConfig(**kw, dtype=jnp.bfloat16))
    tcfg = tgqe.GQEConfig(**kw, dtype=BF16)
    model = tgqe.init_gqe(torch.Generator().manual_seed(0), tcfg)
    tleaves = convert.gqe_to_numpy(model)
    jflat = {f"{k}.{kk}" if isinstance(v, dict) else k: vv
             for k, v in jp.items()
             for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)])}
    tflat = {f"{k}.{kk}" if isinstance(v, dict) else k: vv
             for k, v in tleaves.items()
             for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)])}
    assert set(jflat) == set(tflat)
    for name, arr in jflat.items():
        assert arr.dtype == jnp.bfloat16, name
        assert tflat[name].shape == arr.shape, name
    for p in model.parameters():
        assert p.dtype == BF16
    assert all(p.dtype == BF16 for p in tgqe.GQE(tcfg).parameters())
    # the JAX bf16 parameters load bit for bit
    back = convert.gqe_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    for name, arr in jflat.items():
        t = dict(back.named_parameters())[name]
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            np.asarray(arr).view(np.uint16))


def _flat(tree):
    out = {}
    for k, v in tree.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)]):
            out[f"{k}.{kk}" if isinstance(v, dict) else k] = vv
    return out


@pytest.mark.parametrize("decoder", ["bilinear", "box"])
def test_gqe_bf16_loss_and_grads_match_jax(decoder):
    """GQE at bf16 runs every operation in bf16 on both sides (no f32
    products), and XLA keeps f32 between the operations it fuses where
    PyTorch rounds after each: the two bf16 computations part by a few
    bf16 steps, and by more in gradients that cancel (the attention
    biases of the box head).  So both are held to the f32 gradient of
    the same bf16 values: per leaf, the port's mean|diff| / mean|ref|
    within twice JAX's own plus 1e-3 (measured: at most 1.3 times
    JAX's); the losses within 1e-2 of each other (measured 4.2e-4)."""
    kw = dict(n_entities=40, n_modes=2, n_rels=6, embed_dim=8,
              decoder=decoder, intersection="deepsets")
    jcfg = jgqe.GQEConfig(**kw, dtype=jnp.bfloat16)
    jcfg32 = jgqe.GQEConfig(**kw)
    tcfg = tgqe.GQEConfig(**kw, dtype=BF16)
    params = jgqe.init_gqe(jax.random.PRNGKey(1), jcfg)
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = convert.gqe_from_numpy(jax.tree.map(np.asarray, params), tcfg)
    for structure in ("2-chain", "2-inter"):
        spec = STRUCTURES[structure]
        rng = np.random.default_rng(3)
        B = 12
        arrays = (rng.integers(0, 40, (B, spec.n_nodes)).astype(np.int32),
                  rng.integers(0, 2, (B, spec.n_nodes)).astype(np.int32),
                  rng.integers(0, 6, (spec.n_edges,)).astype(np.int32),
                  np.ones((spec.n_edges,), np.float32),
                  rng.integers(0, 40, (B,)).astype(np.int32),
                  rng.integers(0, 40, (B, 3)).astype(np.int32),
                  np.ones((B, 3), np.float32), np.ones((B,), np.float32))
        jargs = list(map(jnp.asarray, arrays))
        jv, jg = jax.value_and_grad(lambda p: jgqe.dense_batch_loss(
            p, jcfg, structure, *jargs))(params)
        with jax.default_matmul_precision("highest"):
            g32 = _flat(jax.grad(lambda p: jgqe.dense_batch_loss(
                p, jcfg32, structure, *jargs))(params32))
        model.zero_grad(set_to_none=True)
        loss = tgqe.dense_batch_loss(model, tcfg, structure,
                                     *map(torch.from_numpy, arrays))
        loss.backward()
        assert abs(float(loss) - float(jv)) <= 1e-2 * abs(float(jv))
        jflat = _flat(jg)
        assert set(jflat) == {n for n, _ in model.named_parameters()}
        for name, p in model.named_parameters():
            got = p.grad if p.grad is not None else torch.zeros_like(p)
            assert got.dtype == BF16 and jflat[name].dtype == jnp.bfloat16
            if np.abs(_f(g32[name])).max() == 0:
                continue
            e_port = _mean_rel(got, g32[name])
            e_jax = _mean_rel(jflat[name], g32[name])
            assert e_port <= 2 * e_jax + 1e-3, (structure, name, e_port,
                                                e_jax)
