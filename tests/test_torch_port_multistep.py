"""K train steps per call (``make_multistep_train_step``, its halo form,
``run_train(steps_per_call=K)``) and the prefetching ``run_train``, on the
CPU:

* the multistep step at K = 4 is bit-equal to 4 ``run_step`` calls
  (losses, parameters, the optimizer's moments and count), through the
  dense encoder and through plain K1/K2;
* against the JAX package's ``make_multistep_train_step`` (its
  ``lax.scan``) and ``make_halo_multistep_train_step`` on the same stacked
  batches, with parameters carried across: losses within 1e-5 relative
  (f32 both sides, sum order only); parameters within 1e-5 absolute
  under SGD, which moves them by lr x gradient (Adam turns tiny gradient
  differences of near-zero elements into lr-sized steps: 1e-4 there, as
  in ``tests/test_torch_port_train.py``);
* ``run_train`` with ``prefetch=2`` is bit-equal to ``prefetch=0``
  within a curriculum phase (the pipeline draws in the synchronous
  loop's order), at K = 1 and K = 3, and across the burn-in switch it
  restarts the draws from the seed, as the reference does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data import store as jstore
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.parallel import halo_train as jht
from mpqe_tpu.parallel import mesh as jmesh
from mpqe_tpu.queries import STRUCTURE_NAMES
from mpqe_tpu.queries import group_queries_by_formula as jgroup
from mpqe_tpu.train import loop as jloop
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.data import pipeline as tpipe
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.parallel import halo_train as tht
from mpqe_tpu_torch.parallel import mesh as tmesh
from mpqe_tpu_torch.queries import group_queries_by_formula as tgroup
from mpqe_tpu_torch.train import loop as tloop

D, K = 16, 4
KG = dict(n_entities=300, n_modes=3, n_base_rels=6, n_triples=3000, seed=3)


def _models(seed=2, n_layers=3):
    kw = dict(n_entities=300, n_modes=3, n_rels=12, embed_dim=D,
              n_layers=n_layers, num_bases=4)
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _jax_named(tree):
    out = {"emb.ent": tree["emb"]["ent"], "emb.var": tree["emb"]["var"]}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            out[f"layers.{i}.{k}"] = v
    for k, v in tree.get("readout", {}).items():
        out[f"readout.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _jax_stores():
    kg = jsamp.make_random_kg(**KG)
    s = jsamp.QuerySampler(kg, seed=3)
    qs = []
    for st in STRUCTURE_NAMES:
        qs += s.sample_queries(st, 12, n_neg=8)
    return jstore.build_stores(jgroup(qs), kg=kg)


def _stacked(structure="3-chain_inter", k=K, batch=16, seed=0):
    """K same-formula numpy batches of ``structure``, stacked [K, ...]."""
    fs = max(_jax_stores()[structure], key=lambda f: f.n_queries)
    rng = np.random.default_rng(seed)
    batches = [jstore.pack_dense_batch_np(
        fs, rng.integers(0, fs.n_queries, batch).astype(np.int64), batch, 4,
        seed + i, False) for i in range(k)]
    return tpipe.stack_batches(batches), batches


def _opt_state(opt):
    st = [(s["mu"].clone(), s["nu"].clone()) for s in opt.state.values()]
    return st, opt.param_groups[0]["count"]


@pytest.mark.parametrize("route", ["dense", "fused_fwd_pallas"])
def test_multistep_bit_equal_to_single_steps(route):
    loss_fn = (None if route == "dense" else functools.partial(
        tm.dense_batch_loss_kernel_fused_fwd, backward="pallas"))
    _, tcfg, _, m1 = _models()
    _, _, _, m2 = _models()
    tc = tloop.TrainConfig(lr=0.01)
    s1 = tloop.TrainState(m1, tloop.make_optimizer(tc, m1.parameters()))
    s2 = tloop.TrainState(m2, tloop.make_optimizer(tc, m2.parameters()))
    one = tloop.make_train_step(tcfg, s1.optimizer, loss_fn)
    multi = tloop.make_multistep_train_step(tcfg, s2.optimizer, loss_fn)
    stacked, batches = _stacked()
    want = [tloop.run_step(one, s1, b) for b in batches]
    got = tloop.run_multistep_stacked(multi, s2, stacked)
    assert got == want and s1.step == s2.step == K
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), n
    (st1, c1), (st2, c2) = _opt_state(s1.optimizer), _opt_state(s2.optimizer)
    assert c1 == c2 == K
    for (mu1, nu1), (mu2, nu2) in zip(st1, st2):
        assert torch.equal(mu1, mu2) and torch.equal(nu1, nu2)
    # run_multistep stacks the same batches itself
    _, _, _, m3 = _models()
    s3 = tloop.TrainState(m3, tloop.make_optimizer(tc, m3.parameters()))
    multi3 = tloop.make_multistep_train_step(tcfg, s3.optimizer, loss_fn)
    assert tloop.run_multistep(multi3, s3, batches) == want


def _param_tol(optimizer):
    return 1e-5 if optimizer == "sgd" else 1e-4


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_multistep_matches_jax_scan(optimizer):
    jcfg, tcfg, params, model = _models()
    tc_kw = dict(lr=0.01, optimizer=optimizer)
    jopt = jloop.make_optimizer(jloop.TrainConfig(**tc_kw))
    jstep = jloop.make_multistep_train_step(jcfg, jopt)
    stacked, _ = _stacked()
    arrays = [np.asarray(getattr(stacked, f)) for f in tloop.BATCH_FIELDS]
    with jax.default_matmul_precision("highest"):
        jp, _, jl = jstep(params, jopt.init(params), stacked.structure,
                          *map(jnp.asarray, arrays))
    state = tloop.TrainState(model, tloop.make_optimizer(
        tloop.TrainConfig(**tc_kw), model.parameters()))
    tl = tloop.run_multistep_stacked(
        tloop.make_multistep_train_step(tcfg, state.optimizer), state,
        stacked)
    for a, b in zip(np.asarray(jl), tl):
        assert abs(a - b) <= 1e-5 * abs(a), (jl, tl)
    want = _jax_named(jp)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=_param_tol(optimizer), err_msg=n)


@pytest.mark.parametrize("kind", ["ring", "gather"])
def test_halo_multistep_matches_jax(kind):
    """4 parts each side: the port's on ``["cpu"] * 4``, JAX's on 4 of the
    conftest's 8 CPU devices; SGD (see the module doc)."""
    jcfg, tcfg, params, model = _models(n_layers=2)
    tc_kw = dict(lr=0.02, optimizer="sgd", batch_size=16, n_neg=4)
    jtc, ttc = jloop.TrainConfig(**tc_kw), tloop.TrainConfig(**tc_kw)
    jmsh = jmesh.make_mesh((4, 1), devices=jax.devices()[:4])
    jstep = jht.make_halo_multistep_train_step(jcfg, jtc, jmsh,
                                               layer_kind=kind)
    stacked, _ = _stacked("2-chain", k=3)
    arrays = [np.asarray(getattr(stacked, f)) for f in tloop.BATCH_FIELDS]
    jopt = jloop.make_optimizer(jtc)
    with jax.default_matmul_precision("highest"):
        jp, _, jl = jstep(params, jopt.init(params), stacked.structure,
                          *map(jnp.asarray, arrays))
    mesh = tmesh.make_mesh((4, 1), devices=["cpu"] * 4)
    state = tloop.TrainState(model, tloop.make_optimizer(
        ttc, model.parameters()))
    step = tht.make_halo_multistep_train_step(tcfg, state.optimizer, mesh,
                                              layer_kind=kind)
    tl = tloop.run_multistep_stacked(step, state, stacked)
    assert len(tl) == 3 and state.step == 3
    for a, b in zip(np.asarray(jl), tl):
        assert abs(a - b) <= 1e-5 * abs(a), (jl, tl)
    want = _jax_named(jp)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0,
                                   atol=1e-5, err_msg=n)


# ------------------------------------------------------------- run_train
def _train_queries(structures):
    s = tsamp.QuerySampler(tsamp.make_random_kg(**KG), seed=3)
    qs = []
    for st in structures:
        qs += s.sample_queries(st, 12, n_neg=8, n_hard_neg=4)
    return tgroup(qs)


def _run(prefetch, k, structures, steps, conv_window=100, burn_in=None):
    _, tcfg, _, model = _models()
    tc = tloop.TrainConfig(lr=0.01, batch_size=16, n_neg=4, max_steps=steps,
                           conv_window=conv_window, seed=4,
                           **({"burn_in_structure": burn_in}
                              if burn_in else {}))
    state = tloop.TrainState(model, tloop.make_optimizer(
        tc, model.parameters()))
    log = []
    tloop.run_train(state, tcfg, tc, _train_queries(structures),
                    log_fn=log.append, prefetch=prefetch,
                    steps_per_call=k)
    return log, state


@pytest.mark.parametrize("k", [1, 3])
def test_run_train_prefetch_bit_equal_to_synchronous(k):
    # no 1-chain: one phase throughout
    structures = ("2-chain", "2-inter", "3-inter_chain")
    a, sa = _run(0, k, structures, 12)
    b, sb = _run(2, k, structures, 12)
    strip = [{kk: v for kk, v in r.items() if kk != "seconds"}
             for r in a]
    assert strip == [{kk: v for kk, v in r.items() if kk != "seconds"}
                     for r in b]
    assert len(a) == 12 // k and len({r["structure"] for r in a}) > 1
    if k > 1:
        assert all(r["k"] == k for r in a)
    for (n, p), q in zip(sa.model.named_parameters(), sb.model.parameters()):
        assert torch.equal(p, q), n


def test_run_train_prefetch_restarts_from_the_seed_at_burn_in():
    """Equal through the burn-in phase; then the pipeline is restarted
    from ``tc.seed`` (the reference's rule) while the synchronous loop
    draws on: the first full-phase batch is the one a fresh pipeline of
    the full phase draws first."""
    structures = ("1-chain", "2-chain", "3-chain")
    a, _ = _run(0, 1, structures, 14, conv_window=4)
    b, _ = _run(2, 1, structures, 14, conv_window=4)

    def phase(log, name):
        return [{kk: v for kk, v in r.items() if kk != "seconds"}
                for r in log if r.get("phase") == name]

    assert phase(a, "burn_in") == phase(b, "burn_in") != []
    assert any(r.get("event") == "burn_in_done" for r in b)
    from mpqe_tpu_torch.data.store import build_stores

    stores = build_stores(_train_queries(structures))
    fresh = tpipe.BatchPipeline(stores, 16, 4, structures=list(stores),
                                seed=4, prefetch=1).start()
    try:
        first = next(fresh)
    finally:
        fresh.stop()
    assert phase(b, "full")[0]["structure"] == first.structure
