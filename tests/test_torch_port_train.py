"""The port's training slice against the JAX package on the CPU: the f32
encoder, the fused encoder's two gradient paths, the losses, the batch
store and packer, the optimizer, a 3-step trajectory, the batched
evaluation, checkpoints, the CLI and its SIGTERM behaviour.  Inputs come
from numpy with a seed; parameters from the JAX ``init_mpqe``, carried
across with ``model_from_numpy``.  Each tolerance's reason is stated
where it is used.
"""

import dataclasses
import functools
import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data import store as jstore
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.queries import STRUCTURE_NAMES, STRUCTURES
from mpqe_tpu.queries import group_queries_by_formula as jgroup
from mpqe_tpu.train import evaluation as jeval
from mpqe_tpu.train import loop as jloop
from mpqe_tpu_torch.convert import model_from_numpy, model_to_numpy
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.data import store as tstore
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.queries import group_queries_by_formula as tgroup
from mpqe_tpu_torch.train import checkpoint as tckpt
from mpqe_tpu_torch.train import evaluation as teval
from mpqe_tpu_torch.train import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ENT, N_MODES, N_RELS, D = 50, 3, 9, 16
READOUTS = ("tgt", "sum", "max", "concat", "mlp")


def _models(nb=4, readout="tgt", seed=1, n_ent=N_ENT, n_modes=N_MODES,
            n_rels=N_RELS):
    kw = dict(n_entities=n_ent, n_modes=n_modes, n_rels=n_rels, embed_dim=D,
              n_layers=3, num_bases=nb, readout=readout)
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:  # non-zero biases (init is zeros)
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _inputs(structure, B=20, seed=0):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_RELS, (spec.n_edges,)).astype(np.int32),
            rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _jax_named(tree):
    """{port parameter name: numpy array} of a JAX parameter pytree."""
    out = {"emb.ent": tree["emb"]["ent"], "emb.var": tree["emb"]["var"]}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            out[f"layers.{i}.{k}"] = v
    for k, v in tree.get("readout", {}).items():
        out[f"readout.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(loss, list(model.parameters()),
                             allow_unused=True)
    return {n: (np.zeros(p.shape, np.float32) if g is None else g.numpy())
            for (n, p), g in zip(model.named_parameters(), gs)
            if n in names}


# ---------------------------------------------------------------- encoders
@pytest.mark.parametrize("readout", READOUTS)
@pytest.mark.parametrize("nb", [4, None], ids=["basis", "full"])
def test_encode_dense_matches_jax(readout, nb):
    # both sides f32 with HIGHEST matmuls on the JAX side: only sum order
    # differs (measured <= 4e-7)
    jcfg, tcfg, params, model = _models(nb, readout)
    for structure in STRUCTURE_NAMES:
        arrays = _inputs(structure, seed=3)
        with jax.default_matmul_precision("highest"):
            want = jm.encode_dense(params, jcfg, structure,
                                   *map(jnp.asarray, arrays))
        with torch.no_grad():
            got = tm.encode_dense(model, tcfg, structure,
                                  *map(torch.from_numpy, arrays))
        assert got.shape == (20, D)
        assert _rel(got.numpy(), want) <= 1e-5, (structure, readout)


@pytest.mark.parametrize("nb", [4, None], ids=["basis", "full"])
def test_embeddings_and_dense_layer_match_jax(nb):
    # gathers and the one-hot select are exact; the layer is f32 products
    # in another sum order (measured <= 3e-7)
    from mpqe_tpu.models import embeddings as jemb
    from mpqe_tpu.ops import rgcn as jrgcn
    from mpqe_tpu_torch.models import embeddings as temb
    from mpqe_tpu_torch.ops import rgcn as trgcn

    jcfg, tcfg, params, model = _models(nb)
    for structure in STRUCTURE_NAMES:
        spec = STRUCTURES[structure]
        ne, nm, er, en = _inputs(structure, seed=4)
        is_var = np.isin(np.arange(spec.n_nodes), spec.anchor_slots,
                         invert=True).astype(np.float32)
        want_d = jemb.embed_nodes_dense(params["emb"], jnp.asarray(ne),
                                        jnp.asarray(nm), jnp.asarray(is_var))
        want_t = jemb.embed_nodes_template(params["emb"], jnp.asarray(ne),
                                           jnp.asarray(nm), spec.anchor_slots,
                                           spec.n_nodes)
        with torch.no_grad():
            got_d = temb.embed_nodes_dense(model.emb, torch.from_numpy(ne),
                                           torch.from_numpy(nm),
                                           torch.from_numpy(is_var))
            got_t = temb.embed_nodes_template(model.emb, torch.from_numpy(ne),
                                              torch.from_numpy(nm),
                                              spec.anchor_slots, spec.n_nodes)
            got_l = trgcn.rgcn_dense_template(
                got_t, model.layers[0], spec.edge_src, spec.edge_dst,
                torch.from_numpy(er), torch.from_numpy(en))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        with jax.default_matmul_precision("highest"):
            want_l = jrgcn.rgcn_dense_template(
                want_t, params["layers"][0], spec.edge_src, spec.edge_dst,
                jnp.asarray(er), jnp.asarray(en))
        assert _rel(got_l.numpy(), want_l) <= 1e-5, structure


@pytest.mark.parametrize("backward", ["xla", "pallas"])
def test_encode_dense_fused_vjp_matches_jax(backward):
    # xla: both recompute the f32 encoder, 1e-5 (sum order only).
    # pallas: the port's plain K1/K2 vs the Pallas kernels in interpret
    # mode, 1e-4 on these flip-free inputs (tests/test_torch_port_fused_tgt)
    jcfg, tcfg, params, model = _models()
    tol = 1e-5 if backward == "xla" else 1e-4
    # one structure of each depth (test_torch_port_fused_tgt.py covers
    # K1/K2 on all seven)
    for structure in ("1-chain", "3-inter_chain", "3-chain"):
        ne, nm, er, en = _inputs(structure, seed=5)
        g = np.random.default_rng(6).normal(size=(20, D)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            out, vjp = jax.vjp(lambda p, e: jm.encode_dense_fused(
                p, jcfg, structure, jnp.asarray(ne), jnp.asarray(nm),
                jnp.asarray(er), e, None, 8, True, False, False, None,
                backward, 8), params, jnp.asarray(en))
            dp, den = vjp(jnp.asarray(g))
        en_t = torch.from_numpy(en).requires_grad_()
        q = tm.encode_dense_fused(model, tcfg, structure,
                                  torch.from_numpy(ne), torch.from_numpy(nm),
                                  torch.from_numpy(er), en_t, None, backward)
        assert _rel(q.detach().numpy(), out) <= 1e-4, structure
        names = [n for n, _ in model.named_parameters()]
        got = torch.autograd.grad(q, list(model.parameters()) + [en_t],
                                  torch.from_numpy(g), allow_unused=True)
        want = _jax_named(dp)
        for n, gr in zip(names, got):
            if np.abs(want[n]).max() > 0:
                assert _rel(gr.numpy(), want[n]) <= tol, (structure, n)
        assert _rel(got[-1].numpy(), den) <= tol, structure


def test_encode_dense_fused_anchor_rows_forms():
    # stacked and per-slot anchor rows give the same output and the same
    # anchor-row cotangents, in both modes
    _, tcfg, _, model = _models()
    structure = "3-chain_inter"
    ne, nm, er, en = map(torch.from_numpy, _inputs(structure, seed=8))
    slots = tm.anchor_gather_slots(tcfg, structure)
    g = torch.from_numpy(
        np.random.default_rng(1).normal(size=(20, D)).astype(np.float32))
    for backward in ("xla", "pallas"):
        rows = torch.stack([model.emb.ent[ne[:, s].long()] for s in slots],
                           dim=1).detach().requires_grad_()
        cols = tuple(rows[:, k].detach().clone().requires_grad_()
                     for k in range(len(slots)))
        qs = tm.encode_dense_fused(model, tcfg, structure, ne, nm, er, en,
                                   rows, backward)
        qt = tm.encode_dense_fused(model, tcfg, structure, ne, nm, er, en,
                                   cols, backward)
        assert torch.equal(qs, qt), backward
        (d_rows,) = torch.autograd.grad(qs, [rows], g)
        d_cols = torch.autograd.grad(qt, list(cols), g)
        for k in range(len(slots)):
            assert torch.equal(d_rows[:, k], d_cols[k]), backward


# ------------------------------------------------------------------ losses
def _loss_inputs(structure, B=20, K=3, seed=10):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, N_ENT, (B,)).astype(np.int32)
    neg = rng.integers(0, N_ENT, (B, K)).astype(np.int32)
    nmask = (rng.random((B, K)) > 0.2).astype(np.float32)
    qmask = (np.arange(B) < B - 3).astype(np.float32)
    return (*_inputs(structure, B, seed), tgt, neg, nmask, qmask)


@pytest.mark.parametrize("which", ["dense", "fused_fwd_pallas"])
def test_batch_losses_match_jax(which):
    # dense: f32 both sides, 1e-5.  fused_fwd with the pallas backward:
    # plain K1/K2 vs the interpret kernels, 1e-4 (flip-free inputs)
    jcfg, tcfg, params, model = _models()
    tol = 1e-5 if which == "dense" else 1e-4
    for structure in ("1-chain", "3-chain", "3-inter_chain"):
        arrays = _loss_inputs(structure)
        if which == "dense":
            jfn = jm.dense_batch_loss
            tfn = tm.dense_batch_loss
        else:
            jfn = functools.partial(jm.dense_batch_loss_kernel_fused_fwd,
                                    block=8, interpret=True,
                                    backward="pallas", bwd_block=8)
            tfn = functools.partial(tm.dense_batch_loss_kernel_fused_fwd,
                                    backward="pallas")
        with jax.default_matmul_precision("highest"):
            jv, jg = jax.value_and_grad(lambda p: jfn(
                p, jcfg, structure, *map(jnp.asarray, arrays)))(params)
        tv = tfn(model, tcfg, structure, *map(torch.from_numpy, arrays))
        tv_f = float(tv.detach())
        assert abs(tv_f - float(jv)) <= tol * abs(float(jv)), structure
        got, want = _grads(model, tv), _jax_named(jg)
        assert got["emb.ent"].shape == (N_ENT, D)  # dense, as in JAX
        for n, w in want.items():
            if np.abs(w).max() > 0:
                assert _rel(got[n], w) <= tol, (structure, n)


# ------------------------------------------------------------ data: store
def _kg_queries(seed=3, n_train=12, n_val=6):
    kw = dict(n_entities=300, n_modes=3, n_base_rels=6, n_triples=3000,
              seed=seed)
    jkg, tkg = jsamp.make_random_kg(**kw), tsamp.make_random_kg(**kw)
    js, ts = jsamp.QuerySampler(jkg, seed=seed), tsamp.QuerySampler(
        tkg, seed=seed)
    out = {}
    for name, (s, grp) in {"j": (js, jgroup), "t": (ts, tgroup)}.items():
        tr, va = [], []
        for st in STRUCTURE_NAMES:
            tr += s.sample_queries(st, n_train, n_neg=8)
            va += s.sample_queries(st, n_val, n_neg=16)
        out[name] = (grp(tr), grp(va))
    return jkg, tkg, out["j"], out["t"]


def test_store_and_packer_match_jax():
    jkg, tkg, (jtr, _), (ttr, _) = _kg_queries()
    js, ts = jstore.build_stores(jtr, kg=jkg), tstore.build_stores(ttr,
                                                                  kg=tkg)
    assert list(js) == list(ts)
    fields = ("anchors", "targets", "neg_pool", "neg_ptr", "hard_pool",
              "hard_ptr", "fallback_pool")
    seed = 0
    for s in js:
        assert len(js[s]) == len(ts[s])
        for a, b in zip(js[s], ts[s]):
            assert a.formula.rels == b.formula.rels
            for f in fields:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            for use_hard in (False, True):
                seed += 1
                pick = np.arange(a.n_queries)[::-1].astype(np.int64)
                ba = jstore.pack_dense_batch_np(a, pick, 16, 5, seed,
                                                use_hard)
                bb = tstore.pack_dense_batch_np(b, pick, 16, 5, seed,
                                                use_hard)
                assert (ba.structure, ba.n_queries, ba.used_hard) == (
                    bb.structure, bb.n_queries, bb.used_hard)
                for f in tloop.BATCH_FIELDS:
                    np.testing.assert_array_equal(getattr(ba, f),
                                                  getattr(bb, f), f)


def test_packer_fallback_pool_matches_jax():
    # queries without sampled negatives draw from the same-mode pool,
    # excluding the target (probing forward on a hit)
    jkg, tkg, (jtr, _), (ttr, _) = _kg_queries(seed=4)
    s = "1-chain"
    f, tf = next(iter(jtr[s])), next(iter(ttr[s]))
    jq = [dataclasses.replace(q, neg_samples=()) for q in jtr[s][f]]
    tq = [dataclasses.replace(q, neg_samples=()) for q in ttr[s][tf]]
    pool = jkg.entities_of_mode(f.target_mode)[:3]  # tiny: hits the target
    a = jstore.build_formula_store(f, jq, fallback_pool=pool)
    b = tstore.build_formula_store(tf, tq, fallback_pool=pool)
    for seed in range(5):
        pick = np.zeros(4, np.int64)
        ba = jstore.pack_dense_batch_np(a, pick, 8, 6, seed)
        bb = tstore.pack_dense_batch_np(b, pick, 8, 6, seed)
        for fld in tloop.BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(ba, fld), getattr(bb, fld))


# ------------------------------------------------------------- optimizer
OPT_CONFIGS = {
    "adam_const": dict(),
    "adam_cosine": dict(lr_schedule="cosine", max_steps=4),
    "adam_warmup_cosine": dict(lr_schedule="warmup_cosine", warmup_steps=2,
                               max_steps=6),
    "adamw": dict(weight_decay=1e-2),
    "adam_clip": dict(grad_clip_norm=0.5),
    "adam_clip_inactive": dict(grad_clip_norm=1e3),
    "sgd": dict(optimizer="sgd", lr_schedule="cosine", max_steps=3),
}


@pytest.mark.parametrize("name", list(OPT_CONFIGS))
def test_make_optimizer_matches_optax(name):
    # the schedule to 1e-8 (float32 in optax, float64 here); then three
    # updates on the same gradients, parameters to 1e-6 absolute: the same
    # f32 formulas in the same order, except that XLA's float32 pow and
    # torch's differ by an ulp of b2^t for some t, which is 2e-5 of the
    # bias correction 1 - b2^t at t = 3 and so up to ~lr * 2e-5 per update
    tc_kw = dict(lr=0.01, **OPT_CONFIGS[name])
    jtc, ttc = jloop.TrainConfig(**tc_kw), tloop.TrainConfig(**tc_kw)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: (3 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    jopt = jloop.make_optimizer(jtc)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = tloop.make_optimizer(ttc, list(tp.values()))
    sched = tloop.lr_schedule(ttc)
    for step, g in enumerate(grads):
        if ttc.lr_schedule == "cosine":
            want_lr = optax.cosine_decay_schedule(0.01, ttc.max_steps,
                                                  0.01)(step)
            assert abs(sched(step) - float(want_lr)) <= 1e-8
        elif ttc.lr_schedule == "warmup_cosine":
            want_lr = optax.warmup_cosine_decay_schedule(
                0.0, 0.01, 2, ttc.max_steps, 0.01 * 0.01)(step)
            assert abs(sched(step) - float(want_lr)) <= 1e-8
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{name} step {step} {k}")


def test_sgd_with_weight_decay_raises():
    with pytest.raises(ValueError):
        tloop.make_optimizer(tloop.TrainConfig(optimizer="sgd",
                                               weight_decay=0.1),
                             [torch.nn.Parameter(torch.zeros(2))])


@pytest.mark.parametrize("vals", [[1.0] * 10, list(range(10, 0, -1)),
                                  [0.0] * 10, [5, 5, 5, 5, 5, 5, 5, 5, 4.9, 4.9]])
def test_check_conv_matches_jax(vals):
    import collections

    for tol in (1e-4, 1e-2):
        a = collections.deque(vals, maxlen=10)
        b = collections.deque(vals, maxlen=10)
        assert tloop.check_conv(a, tol) == jloop.check_conv(b, tol)


# ------------------------------------------------------------ trajectory
def _trajectory(kernel, optimizer, n_steps=3):
    """(JAX losses, port losses, JAX params, port model) after the same
    numpy-packed batches through each side's make_train_step."""
    kw = dict(n_entities=300, n_modes=3, n_rels=12)
    jcfg, tcfg, params, model = _models(n_ent=300, n_modes=3, n_rels=12,
                                        seed=2)
    jkg, _, (jtr, _), _ = _kg_queries(seed=3)
    assert jkg.n_rels == kw["n_rels"]
    stores = jstore.build_stores(jtr, kg=jkg)
    tc_kw = dict(lr=0.01, optimizer=optimizer)
    jtc, ttc = jloop.TrainConfig(**tc_kw), tloop.TrainConfig(**tc_kw)
    if kernel == "dense":
        jfn, tfn = None, None
    elif kernel == "fused":
        jfn = functools.partial(jm.dense_batch_loss_kernel_fused, chunk=8,
                                interpret=True)
        tfn = functools.partial(tm.dense_batch_loss_kernel_fused, chunk=8)
    elif kernel == "blocked":
        jfn = functools.partial(jm.dense_batch_loss_kernel_blocked,
                                queries_per_block=8, chunk=8, interpret=True)
        tfn = functools.partial(tm.dense_batch_loss_kernel_blocked,
                                queries_per_block=8, chunk=8)
    else:
        jfn = functools.partial(jm.dense_batch_loss_kernel_fused_fwd,
                                block=8, interpret=True, backward="pallas",
                                bwd_block=8)

        def tfn(*a):
            return tm.dense_batch_loss_kernel_fused_fwd(*a,
                                                        backward="pallas")
    jopt = jloop.make_optimizer(jtc)
    jstep = jloop.make_train_step(jcfg, jopt, jfn)
    jstate = jopt.init(params)
    topt = tloop.make_optimizer(ttc, model.parameters())
    tstep = tloop.make_train_step(tcfg, topt, tfn)
    state = tloop.TrainState(model=model, optimizer=topt)
    jl, tl = [], []
    for i, s in enumerate(["3-chain", "2-inter", "3-chain_inter"][:n_steps]):
        fs = max(stores[s], key=lambda f: f.n_queries)
        batch = jstore.pack_dense_batch_np(
            fs, np.arange(fs.n_queries, dtype=np.int64), 16, 4, i, False)
        with jax.default_matmul_precision("highest"):
            params, jstate, loss = jstep(
                params, jstate, s,
                *(jnp.asarray(getattr(batch, f)) for f in tloop.BATCH_FIELDS))
        jl.append(float(loss))
        tl.append(tloop.run_step(tstep, state, batch))
    return jl, tl, params, model


def test_trajectory_adam_dense_matches_jax():
    # f32 both sides: losses to 1e-5 relative; Adam turns each gradient
    # element into a step of about lr = 1e-2 whatever its size, so tiny
    # gradient differences of near-zero elements move parameters by up
    # to ~1e-5 per step: 1e-4 absolute after 3 steps
    jl, tl, params, model = _trajectory("dense", "adam")
    for a, b in zip(jl, tl):
        assert abs(a - b) <= 1e-5 * abs(a), (jl, tl)
    want = _jax_named(params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=1e-4, err_msg=n)


def test_trajectory_sgd_fused_pallas_matches_jax():
    # plain K1/K2 vs the interpret kernels: gradients agree to ~1e-6 of
    # their max (flip-free), and SGD moves parameters by lr * gradient,
    # so losses agree to 1e-4 relative and parameters to 1e-6 absolute
    # (SGD keeps Adam's sign-like first step from turning near-zero
    # gradient noise into lr-sized differences)
    jl, tl, params, model = _trajectory("fused_fwd", "sgd")
    for a, b in zip(jl, tl):
        assert abs(a - b) <= 1e-4 * abs(a), (jl, tl)
    want = _jax_named(params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("kernel", ["fused", "blocked"])
def test_trajectory_sparse_kernels_match_jax(kernel):
    # --kernel fused: f32 on both sides (plain K5 vs the interpret kernel,
    # sum order only), the dense trajectory's Adam tolerances.
    # --kernel blocked: plain K6 vs the interpret kernels (same bf16
    # rounding points, f32 sum order only), SGD as for fused_fwd above
    optimizer = "adam" if kernel == "fused" else "sgd"
    jl, tl, params, model = _trajectory(kernel, optimizer)
    for a, b in zip(jl, tl):
        assert abs(a - b) <= 1e-5 * abs(a), (jl, tl)
    want = _jax_named(params)
    atol = 1e-4 if optimizer == "adam" else 1e-6
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=atol, err_msg=n)


# ------------------------------------------------------------ evaluation
def test_eval_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        pos = rng.integers(0, 5, 7).astype(np.float64)
        neg = rng.integers(0, 5, 11).astype(np.float64)
        assert teval.roc_auc(pos, neg) == jeval.roc_auc(pos, neg)
    pos = rng.normal(size=9).astype(np.float32)
    neg = rng.normal(size=(9, 4)).astype(np.float32)
    mask = (rng.random((9, 4)) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(teval._apr_percentiles(pos, neg, mask),
                                  jeval._apr_percentiles(pos, neg, mask))
    pool = rng.integers(0, 100, 20).astype(np.int32)
    ptr = np.array([0, 3, 3, 10, 20], np.int64)
    a = teval._sample_csr(pool, ptr, 6, np.random.default_rng(4))
    b = jeval._sample_csr(pool, ptr, 6, np.random.default_rng(4))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("nb", [None, 4], ids=["full", "basis"])
def test_evaluate_batched_matches_jax(nb):
    # full-weight model: both sides run the f32 per-query-relation encoder
    # (no K3 anywhere), so scores agree to ~1e-7 and AUC / APR to 1e-6.
    # basis model: the port takes K3's plain version (bf16 operands), the
    # JAX CPU backend its f32 encoder: scores differ by ~1e-3, which can
    # reorder near-tied candidates, so macro AUC agrees to 1e-3
    jkg, tkg, (_, jva), (_, tva) = _kg_queries(seed=5, n_train=1, n_val=12)
    jcfg, tcfg, params, model = _models(nb, n_ent=300, n_modes=3, n_rels=12)
    jres = jeval.evaluate_batched(params, jcfg, jeval.make_eval_set(jva))
    tres = teval.evaluate_batched(model, tcfg, teval.make_eval_set(tva))
    if nb is None:
        for a, b in ((jres.auc_by_structure, tres.auc_by_structure),
                     (jres.apr_by_structure, tres.apr_by_structure),
                     (jres.hard_auc_by_structure,
                      tres.hard_auc_by_structure)):
            assert set(a) == set(b)
            for k in a:
                assert abs(a[k] - b[k]) <= 1e-6, k
    else:
        assert abs(jres.macro_auc - tres.macro_auc) <= 1e-3
    assert set(jres.flat()) == set(tres.flat())


def test_evaluate_batched_refuses_other_configs():
    # a GQE config is taken (tests/test_torch_port_gqe_train.py holds it to
    # JAX); a config of no model raises
    from mpqe_tpu.models import gqe as jgqe
    from mpqe_tpu_torch.convert import gqe_from_numpy
    from mpqe_tpu_torch.models import gqe as tgqe

    jkg, tkg, (_, jva), (_, tva) = _kg_queries(seed=5, n_train=1, n_val=4)
    kw = dict(n_entities=300, n_modes=3, n_rels=12, embed_dim=D,
              decoder="distmult", soft_and=True)
    jcfg, tcfg = jgqe.GQEConfig(**kw), tgqe.GQEConfig(**kw)
    params = jgqe.init_gqe(jax.random.PRNGKey(4), jcfg)
    model = gqe_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    jres = jeval.evaluate_batched(params, jcfg, jeval.make_eval_set(jva))
    tres = teval.evaluate_batched(model, tcfg, teval.make_eval_set(tva))
    assert set(jres.flat()) == set(tres.flat())
    assert abs(jres.macro_auc - tres.macro_auc) <= 1e-6

    class OtherConfig:
        pass

    with pytest.raises(TypeError, match="OtherConfig"):
        teval.evaluate_batched(model, OtherConfig(),
                               teval.make_eval_set(tva))


# ---------------------------------------------------- checkpoints and CLI
CLI = ["--device", "cpu", "--data", "synthetic", "--embed_dim", "16",
       "--n_layers", "2", "--num_bases", "4", "--batch_size", "16",
       "--n_neg", "2", "--syn_entities", "120", "--syn_triples", "400",
       "--syn_train_queries", "70", "--syn_val_queries", "28"]


def test_checkpoint_round_trip(tmp_path):
    _, tcfg, _, model = _models()
    tc = tloop.TrainConfig(lr=0.01)
    state = tloop.TrainState(model, tloop.make_optimizer(
        tc, model.parameters()), step=0)
    batch = tstore.pack_dense_batch_np(
        tstore.build_formula_store(*_one_formula()), np.zeros(2, np.int64),
        8, 2, 0)
    step = tloop.make_train_step(tcfg, state.optimizer)
    for _ in range(2):
        tloop.run_step(step, state, batch)
    path = tckpt.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "step_2"
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    _, _, _, fresh = _models(seed=9)
    tmpl = tloop.TrainState(fresh, tloop.make_optimizer(tc,
                                                        fresh.parameters()))
    restored = tckpt.restore_checkpoint(path, tmpl)
    assert restored.step == 2
    a, b = model_to_numpy(model), model_to_numpy(restored.model)
    for n, p in model.named_parameters():
        assert torch.equal(p, dict(restored.model.named_parameters())[n])
    # the optimizer continues identically from the restored state
    tloop.run_step(step, state, batch)
    tloop.run_step(tloop.make_train_step(tcfg, restored.optimizer), restored,
                   batch)
    for n, p in model.named_parameters():
        assert torch.equal(p, dict(restored.model.named_parameters())[n]), n
    assert a.keys() == b.keys()


def _one_formula():
    _, _, _, (ttr, _) = _kg_queries(seed=6, n_train=4, n_val=1)
    f, qs = next(iter(ttr["2-chain"].items()))
    return f, qs


def test_checkpoint_manager_keeps_best(tmp_path):
    _, _, _, model = _models()
    opt = tloop.make_optimizer(tloop.TrainConfig(), model.parameters())
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_best=2)
    for step, metric in [(1, 0.5), (2, 0.7), (3, 0.6), (4, None)]:
        mgr.save(tloop.TrainState(model, opt, step), metric=metric)
    assert sorted(os.listdir(tmp_path)) == ["scores.json", "step_2",
                                            "step_3", "step_4"]
    assert mgr.best().endswith("step_2")
    again = tckpt.CheckpointManager(str(tmp_path), keep_best=1)
    assert again.best().endswith("step_2")
    assert not os.path.isdir(tmp_path / "step_3")


def test_train_cli_on_cpu_and_resume(tmp_path, capsys):
    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "run")
    main(CLI + ["--kernel", "fused_fwd", "--fused_backward", "pallas",
                "--steps", "12", "--val_every", "6", "--run_dir", run])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("final step=12 macro_auc=")
    assert {"config.json", "model_config.json", "metrics.jsonl",
            "ckpt"} <= set(os.listdir(run))
    assert "step_12" in os.listdir(os.path.join(run, "ckpt"))
    cfg = json.load(open(os.path.join(run, "model_config.json")))
    assert cfg["embed_dim"] == 16 and cfg["num_bases"] == 4
    main(CLI + ["--kernel", "fused_fwd", "--fused_backward", "pallas",
                "--steps", "5", "--val_every", "6", "--resume",
                "--run_dir", run])
    lines = [json.loads(ln) for ln in open(os.path.join(run,
                                                        "metrics.jsonl"))]
    assert any(ln.get("event") == "resumed" for ln in lines)
    assert [ln["step"] for ln in lines if "final" in ln] == [12, 17]


@pytest.mark.parametrize("kernel", [["fused"], ["blocked", "--num_bases",
                                                  "4"]],
                         ids=["fused", "blocked"])
def test_train_cli_sparse_kernels_on_cpu(kernel, tmp_path, capsys):
    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "run")
    main(CLI + ["--kernel", *kernel, "--steps", "6", "--val_every", "3",
                "--run_dir", run])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"final step=6 macro_auc=\S+ macro_apr=\S+", last)
    assert {"config.json", "model_config.json", "metrics.jsonl",
            "ckpt"} <= set(os.listdir(run))
    assert {"step_3", "step_6"} <= set(os.listdir(os.path.join(run, "ckpt")))


def test_cli_blocked_needs_bases(tmp_path):
    from mpqe_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit, match="--kernel blocked requires "
                                         "--num_bases"):
        main(CLI + ["--num_bases", "0", "--kernel", "blocked",
                    "--run_dir", str(tmp_path / "r")])


@pytest.mark.parametrize("flag", [["--trace", "3", "--parallel", "spmd"],
                                  ["--trace", "5"]])
def test_cli_unported_flags_raise(flag, tmp_path):
    """The flags that raised for want of a port, ``--trace`` alone and
    under ``--parallel spmd``, now train on the CPU and write one trace
    under ``<run_dir>/trace`` between their window's events."""
    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "r")
    main(CLI + flag + ["--trace_skip", "1", "--steps", "7", "--val_every",
                       "7", "--run_dir", run])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        events = [(r["event"], r["step"]) for r in map(json.loads, f)
                  if r.get("event", "").startswith("trace_")]
    n = int(flag[1])
    assert events == [("trace_start", 1), ("trace_done", 1 + n)]
    assert len(os.listdir(os.path.join(run, "trace"))) == 1


@pytest.mark.parametrize("flag", [
    ["--shared_negatives", "4"],
    ["--shared_negatives", "4", "--self_adv_tau", "1.0", "--kernel",
     "fused_fwd", "--fused_backward", "pallas"],
    ["--prefetch", "2"],
    ["--steps_per_call", "2"],
    ["--prefetch", "2", "--steps_per_call", "2", "--kernel", "fused_fwd"],
    ["--parallel", "halo_ring", "--steps_per_call", "2"]],
    ids=["shared_negatives", "self_adv_tau", "prefetch", "steps_per_call",
         "prefetch_steps_per_call", "halo_steps_per_call"])
def test_cli_host_path_flags_train(flag, tmp_path, capsys):
    """The training host path's flags train 4 steps: the final line,
    finite losses (with ``--steps_per_call K`` a record per K steps,
    carrying ``k`` and ``loss_mean_k``) and the ``data_loaded`` record's
    ``native_packer``."""
    from mpqe_tpu_torch.data import native
    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "run")
    main(CLI + flag + ["--steps", "4", "--val_every", "2", "--run_dir", run])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"final step=4 macro_auc=\S+ macro_apr=\S+", last)
    records = [json.loads(ln) for ln in open(os.path.join(run,
                                                          "metrics.jsonl"))]
    steps = [r for r in records if "loss" in r]
    k = int(flag[flag.index("--steps_per_call") + 1]) \
        if "--steps_per_call" in flag else 1
    assert len(steps) == 4 // k and steps[-1]["step"] == 4
    assert all(np.isfinite(r["loss"]) for r in steps)
    if k > 1:
        assert all(r["k"] == k and np.isfinite(r["loss_mean_k"])
                   for r in steps)
    loaded = [r for r in records if r.get("event") == "data_loaded"]
    assert loaded[0]["native_packer"] is native.available()


def test_cli_self_adv_tau_needs_shared_negatives(tmp_path):
    from mpqe_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit,
                       match="--self_adv_tau requires --shared_negatives"):
        main(CLI + ["--self_adv_tau", "1.0", "--run_dir",
                    str(tmp_path / "r")])


def test_cli_shared_negatives_needs_a_dense_route(tmp_path):
    from mpqe_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit, match="--shared_negatives requires "
                                         "--kernel dense or fused_fwd"):
        main(CLI + ["--shared_negatives", "4", "--kernel", "fused",
                    "--run_dir", str(tmp_path / "r")])


@pytest.mark.parametrize("flag", [
    ["--dtype", "bfloat16", "--kernel", "fused"],
    ["--dtype", "bfloat16", "--kernel", "blocked", "--num_bases", "4"],
    ["--dtype", "bfloat16", "--parallel", "halo_ring"]])
def test_cli_bf16_sparse_routes_train(flag, tmp_path, capsys):
    """The sparse routes at ``--dtype bfloat16`` train: bf16 leaves,
    finite losses, the final line."""
    from mpqe_tpu_torch.train.__main__ import main

    state = main(CLI + flag + ["--steps", "4", "--val_every", "4",
                               "--run_dir", str(tmp_path / "r")])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"final step=4 macro_auc=\S+ macro_apr=\S+", last)
    assert all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    with open(tmp_path / "r" / "metrics.jsonl") as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    assert len(losses) == 4 and np.all(np.isfinite(losses))


def test_cli_needs_a_card_unless_told_otherwise(tmp_path):
    from mpqe_tpu_torch.train.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(CLI[2:] + ["--run_dir", str(tmp_path / "r")])


def _wait_for_loss_line(metrics_path, proc, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"the CLI exited early rc={proc.returncode}")
        if os.path.exists(metrics_path):
            with open(metrics_path) as f:
                if any('"loss"' in ln for ln in f):
                    return
        time.sleep(0.3)
    raise AssertionError("training never produced a loss line")


PREEMPT = CLI + ["--readout", "sum", "--num_bases", "0", "--n_layers", "1",
                 "--val_every", "1000000", "--structures", "1-chain"]


def test_sigterm_checkpoints_and_resumes(tmp_path):
    """SIGTERM stops at a step boundary, saves the final checkpoint and
    exits 0; --resume continues past the stop (tests/test_preempt.py)."""
    run_dir = str(tmp_path / "run")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpqe_tpu_torch.train", *PREEMPT,
         "--steps", "1000000", "--run_dir", run_dir],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO)
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    try:
        _wait_for_loss_line(metrics_path, proc)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, "graceful preemption must exit 0"
    lines = [json.loads(ln) for ln in open(metrics_path)]
    events = [ln.get("event") for ln in lines]
    assert "preempt_stop" in events and "final_checkpoint" in events
    stop_step = next(ln["step"] for ln in lines
                     if ln.get("event") == "preempt_stop")
    assert stop_step > 0

    from mpqe_tpu_torch.train.__main__ import main

    main([*PREEMPT, "--steps", "20", "--resume", "--run_dir", run_dir])
    lines = [json.loads(ln) for ln in open(metrics_path)]
    final_steps = [ln["step"] for ln in lines if "final" in ln]
    assert final_steps and final_steps[-1] >= stop_step + 20


def test_in_process_main_does_not_hijack_sigterm(tmp_path):
    from mpqe_tpu_torch.train.__main__ import main

    before = signal.getsignal(signal.SIGTERM)
    main([*PREEMPT, "--steps", "10", "--run_dir", str(tmp_path / "run2")])
    assert signal.getsignal(signal.SIGTERM) is before
