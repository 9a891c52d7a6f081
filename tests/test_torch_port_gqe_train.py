"""The port's GQE baselines through training, evaluation and serving,
against the JAX package on the CPU: a 3-step Adam trajectory through each
side's ``make_train_step``, ``evaluate_batched``, ``full_ranking``, the
``QueryServer``, checkpoints, and the train -> evaluate -> serve CLIs on
``--device cpu`` (with ``--bibox_w 0.5``, which the port's run-dir
readers keep).

The KG is ``tests/test_gqe.py``'s (100 entities, 2 modes, 4 base
relations) at d = 16; parameters come from the JAX ``init_gqe``, carried
across with ``convert.gqe_from_numpy``.  Tolerances are stated where they
are used.
"""

import dataclasses
import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data import store as jstore
from mpqe_tpu.models import aggregators as jagg
from mpqe_tpu.models import gqe as jgqe
from mpqe_tpu.queries import STRUCTURE_NAMES
from mpqe_tpu.queries import group_queries_by_formula as jgroup
from mpqe_tpu.serve import QueryServer as JaxServer
from mpqe_tpu.train import evaluation as jeval
from mpqe_tpu.train import loop as jloop
from mpqe_tpu_torch import convert
from mpqe_tpu_torch import serve as tserve
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.models import aggregators as tagg
from mpqe_tpu_torch.models import gqe as tgqe
from mpqe_tpu_torch.queries import group_queries_by_formula as tgroup
from mpqe_tpu_torch.train import checkpoint as tckpt
from mpqe_tpu_torch.train import evaluation as teval
from mpqe_tpu_torch.train import loop as tloop

KG = dict(n_entities=100, n_modes=2, n_base_rels=4, n_triples=400, seed=17)
D = 16
# the model kinds held to JAX through the loop, evaluation and serving
KINDS = {
    "bilinear": dict(decoder="bilinear"),
    "box_softand": dict(decoder="box", soft_and=True),
    "bibox_softand": dict(decoder="bibox", soft_and=True, bibox_w=0.5),
    "neighborhood": dict(decoder="transe", intersection="min",
                         encoder="neighborhood", aggregator="pool"),
}


@functools.lru_cache(maxsize=None)
def _data(seed=3, n_train=12, n_val=6):
    """(JAX kg, port kg, (JAX train, val), (port train, val)): the same
    queries from both packages' samplers."""
    jkg, tkg = jsamp.make_random_kg(**KG), tsamp.make_random_kg(**KG)
    out = {}
    for name, kg, mod, grp in (("j", jkg, jsamp, jgroup),
                               ("t", tkg, tsamp, tgroup)):
        s = mod.QuerySampler(kg, seed=seed)
        tr, va = [], []
        for st in STRUCTURE_NAMES:
            tr += s.sample_queries(st, n_train, n_neg=8)
            va += s.sample_queries(st, n_val, n_neg=16)
        out[name] = (grp(tr), grp(va))
    return jkg, tkg, out["j"], out["t"]


def _models(kind, seed=0):
    """(JAX cfg, port cfg, JAX params, port model, JAX table, port table)
    with non-zero biases; tables None unless the kind needs one."""
    jkg, tkg, _, _ = _data()
    base = dict(n_entities=jkg.n_entities, n_modes=jkg.n_modes,
                n_rels=jkg.n_rels, embed_dim=D, **KINDS[kind])
    jcfg, tcfg = jgqe.GQEConfig(**base), tgqe.GQEConfig(**base)
    params = jax.tree.map(np.asarray,
                          jgqe.init_gqe(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for tree in [params] + [v for v in params.values() if isinstance(v, dict)]:
        for k, v in tree.items():
            if not isinstance(v, dict) and (k.endswith("_b")
                                            or k.startswith("b_")):
                tree[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    model = convert.gqe_from_numpy(params, tcfg, "cpu")
    jt = tt = None
    if tcfg.encoder == "neighborhood":
        jt = jagg.build_neighbor_table_device(jkg, fanout=4, seed=1)
        tt = tagg.build_neighbor_table_device(tkg, fanout=4, seed=1,
                                              device="cpu")
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, params), model, jt, tt)


def _named(tree):
    """{port parameter name: numpy array} of a JAX GQE pytree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{leaf}": np.asarray(a) for leaf, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


# ------------------------------------------------------------ trajectory
@pytest.mark.parametrize("kind", ["bilinear", "box_softand", "neighborhood"])
def test_trajectory_adam_matches_jax(kind):
    # f32 both sides: losses to 1e-5 relative; Adam turns each gradient
    # element into a step of about lr = 1e-2 whatever its size, so tiny
    # gradient differences of near-zero elements move parameters by up to
    # ~1e-5 per step: 1e-4 absolute after 3 steps (the MPQE trajectory's
    # tolerances).  Elements whose gradient is zero in exact arithmetic
    # are the exception: the box intersection's attention is a softmax
    # over the branches, so its second bias, and each first-bias unit
    # active in every branch, get rounding noise (~5e-9, near Adam's eps
    # of 1e-8) that Adam turns into steps of up to lr on either side.
    # Those elements (a gradient <= 1e-7 of the step's largest in every
    # step, on the port's side) are held to Adam's bound instead: moved
    # by at most lr per step.
    jcfg, tcfg, params, model, jt, tt = _models(kind, seed=2)
    jkg, _, (jtr, _), _ = _data()
    stores = jstore.build_stores(jtr, kg=jkg)
    jopt = jloop.make_optimizer(jloop.TrainConfig(lr=0.01))
    jstep = jloop.make_train_step(
        jcfg, jopt, jgqe.dense_batch_loss,
        loss_consts=None if jt is None else {"neighbor_table": jt})
    jstate = jopt.init(params)
    topt = tloop.make_optimizer(tloop.TrainConfig(lr=0.01),
                                model.parameters())
    tstep = tloop.make_train_step(
        tcfg, topt, functools.partial(tgqe.dense_batch_loss,
                                      neighbor_table=tt))
    state = tloop.TrainState(model=model, optimizer=topt)
    jl, tl = [], []
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    noise = {n: torch.ones_like(p, dtype=torch.bool)
             for n, p in model.named_parameters()}
    for i, s in enumerate(["3-chain", "2-inter", "3-chain_inter"]):
        fs = max(stores[s], key=lambda f: f.n_queries)
        batch = jstore.pack_dense_batch_np(
            fs, np.arange(fs.n_queries, dtype=np.int64), 16, 4, i, False)
        with jax.default_matmul_precision("highest"):
            params, jstate, loss = jstep(
                params, jstate, s,
                *(jnp.asarray(getattr(batch, f)) for f in tloop.BATCH_FIELDS))
        jl.append(float(loss))
        tl.append(tloop.run_step(tstep, state, batch))
        top = max(float(p.grad.abs().max()) for p in model.parameters()
                  if p.grad is not None)
        for n, p in model.named_parameters():
            if p.grad is not None:
                noise[n] &= p.grad.abs() <= 1e-7 * top
    for a, b in zip(jl, tl):
        assert abs(a - b) <= 1e-5 * abs(a), (jl, tl)
    want = _named(params)
    assert set(want) == {n for n, _ in model.named_parameters()}
    n_noise = 0
    for n, p in model.named_parameters():
        got, keep = p.detach().numpy(), ~noise[n].numpy()
        np.testing.assert_allclose(got[keep], want[n][keep], rtol=0,
                                   atol=1e-4, err_msg=n)
        moved = np.abs(got - start[n].numpy())[~keep]
        assert (moved <= 3 * 0.01 * 1.001).all(), n
        n_noise += int((~keep).sum() - (moved == 0).sum())
    # only the box kinds have such elements
    assert (n_noise > 0) == (tcfg.decoder == "box"), n_noise


# ------------------------------------------------------------ evaluation
@pytest.mark.parametrize("kind", list(KINDS))
def test_evaluate_batched_matches_jax(kind):
    # the same queries and negatives, f32 scores differing in sum order
    # only: per-structure AUC and APR / 100 to 1e-3
    jcfg, tcfg, params, model, jt, tt = _models(kind)
    _, _, (_, jva), (_, tva) = _data()
    with jax.default_matmul_precision("highest"):
        jres = jeval.evaluate_batched(params, jcfg, jeval.make_eval_set(jva),
                                      neighbor_table=jt)
    tres = teval.evaluate_batched(model, tcfg, teval.make_eval_set(tva),
                                  neighbor_table=tt)
    assert set(jres.flat()) == set(tres.flat())
    for key, want in jres.flat().items():
        got = tres.flat()[key]
        scale = 100.0 if key.startswith("apr") else 1.0
        assert abs(got - want) <= 1e-3 * scale, (key, got, want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_full_ranking_matches_jax(kind):
    # ranks are counts of strictly higher same-mode scores: equal on both
    # sides, so the metrics are equal; max_batch 5 splits every structure
    # into padded chunks
    jcfg, tcfg, params, model, jt, tt = _models(kind, seed=1)
    jkg, tkg, (_, jva), (_, tva) = _data()
    with jax.default_matmul_precision("highest"):
        want = jeval.full_ranking(params, jcfg, jva, jkg.entity_mode,
                                  max_batch=5, neighbor_table=jt)
    got = teval.full_ranking(model, tcfg, tva, tkg.entity_mode, max_batch=5,
                             neighbor_table=tt)
    assert got == want
    # one structure's ranks, query by query
    structure = "3-inter_chain"
    data = teval.make_eval_set(tva, require_negatives=False).by_structure[
        structure]
    arrays = [data[k] for k in ("node_entity", "node_mode", "edge_rel",
                                "edge_norm", "target")]
    emode = tkg.entity_mode.astype(np.int32)
    with jax.default_matmul_precision("highest"):
        jr = jeval._rank_counts_impl(params, jcfg, structure,
                                     *(jnp.asarray(a) for a in arrays),
                                     jnp.asarray(emode), jt)
    with torch.no_grad():
        tr = teval._rank_counts_impl(
            model, tcfg, structure, *(torch.from_numpy(a) for a in arrays),
            torch.from_numpy(emode), None, tt)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_evaluate_refuses_gqe_configs():
    _, tcfg, _, model, _, _ = _models("bilinear")
    _, _, _, (_, tva) = _data()
    with pytest.raises(ValueError, match="evaluate_batched"):
        teval.evaluate(model, tcfg, tva)


# --------------------------------------------------------------- serving
def _served(server, queries, k=10):
    out = server.answer(queries, k=k)
    return (np.stack([a.entity_ids for a in out]),
            np.stack([a.scores for a in out]))


def _server_queries(n_per=5, seed=7):
    js = jsamp.QuerySampler(jsamp.make_random_kg(**KG), seed=seed)
    ts = tsamp.QuerySampler(tsamp.make_random_kg(**KG), seed=seed)
    a, b = [], []
    for s in STRUCTURE_NAMES:
        a += js.sample_queries(s, n_per, n_neg=1)
        b += ts.sample_queries(s, n_per, n_neg=1)
    order = np.random.default_rng(seed).permutation(len(a))
    return [a[i] for i in order], [b[i] for i in order], ts.kg.entity_mode


@pytest.mark.parametrize("kind", list(KINDS))
def test_server_matches_jax(kind):
    # both servers rank in f32 (scores differ in sum order only): the same
    # ids, scores to 1e-5
    jcfg, tcfg, params, model, jt, tt = _models(kind, seed=3)
    jqs, tqs, mode = _server_queries()
    with jax.default_matmul_precision("highest"):
        j_ids, j_sc = _served(JaxServer(params, jcfg, mode,
                                        neighbor_table=jt), jqs)
    server = tserve.QueryServer(model, tcfg, mode, device="cpu",
                                neighbor_table=tt)
    assert (server._ent_norm_t is None) == (tcfg.decoder == "box")
    t_ids, t_sc = _served(server, tqs)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-5)
    for q, ids in zip(tqs, t_ids):
        assert (mode[ids] == q.formula.target_mode).all()


def test_server_needs_the_neighbor_table():
    _, tcfg, _, model, _, _ = _models("neighborhood")
    with pytest.raises(ValueError, match="need neighbor_table="):
        tserve.QueryServer(model, tcfg, np.zeros(100, np.int32),
                           device="cpu")


# ---------------------------------------------------- checkpoints and CLI
def test_checkpoint_round_trip(tmp_path):
    _, tcfg, _, model, _, _ = _models("bibox_softand")
    _, _, _, (ttr, _) = _data()
    from mpqe_tpu_torch.data import store as tstore

    tc = tloop.TrainConfig(lr=0.01)
    state = tloop.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                   tc, init_fn=tgqe.init_gqe)
    fs = tstore.build_stores(ttr)["2-inter"][0]
    batch = tstore.pack_dense_batch_np(fs, np.zeros(2, np.int64), 8, 2, 0)
    step = tloop.make_train_step(tcfg, state.optimizer, tgqe.dense_batch_loss)
    for _ in range(2):
        tloop.run_step(step, state, batch)
    path = tckpt.save_checkpoint(str(tmp_path), state)
    tmpl = tloop.init_train_state(torch.Generator().manual_seed(9), tcfg, tc,
                                  init_fn=tgqe.init_gqe)
    restored = tckpt.restore_checkpoint(path, tmpl)
    assert restored.step == 2
    tloop.run_step(step, state, batch)
    tloop.run_step(tloop.make_train_step(tcfg, restored.optimizer,
                                         tgqe.dense_batch_loss),
                   restored, batch)
    for (n, a), (_, b) in zip(state.model.named_parameters(),
                              restored.model.named_parameters()):
        assert torch.equal(a, b), n
    # the checkpoint holds the reference's leaves and no neighbor table
    sd = torch.load(os.path.join(path, tckpt.STATE_FILE),
                    weights_only=True)["model"]
    jcfg = jgqe.GQEConfig(**dict(dataclasses.asdict(tcfg),
                                 dtype=jnp.float32))
    assert set(sd) == set(_named(jgqe.init_gqe(jax.random.PRNGKey(0),
                                               jcfg)))


CLI = ["--device", "cpu", "--data", "synthetic", "--embed_dim", "16",
       "--batch_size", "16", "--n_neg", "2", "--syn_entities", "120",
       "--syn_triples", "400", "--syn_train_queries", "70",
       "--syn_val_queries", "28"]


def test_cli_train_evaluate_serve_bibox_run(tmp_path, capsys, monkeypatch):
    from mpqe_tpu_torch import evaluate as tev
    from mpqe_tpu_torch.train.__main__ import main as train_main

    run = str(tmp_path / "run")
    train_main(CLI + ["--model", "gqe_softand", "--decoder", "bibox",
                      "--bibox_w", "0.5", "--gqe_encoder", "neighborhood",
                      "--gqe_fanout", "3", "--steps", "4", "--val_every",
                      "2", "--run_dir", run])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"final step=4 macro_auc=\S+ macro_apr=\S+", last)
    mc = json.load(open(os.path.join(run, "model_config.json")))
    assert mc["decoder"] == "bibox" and mc["soft_and"] is True
    assert mc["bibox_w"] == 0.5 and mc["encoder"] == "neighborhood"
    assert "readout" not in mc and "float32" in mc["dtype"]
    assert {"step_2", "step_4"} <= set(os.listdir(os.path.join(run, "ckpt")))

    tev.main(["--run_dir", run, "--device", "cpu", "--ranking"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["step"] == 4 and "auc_macro" in lines[0]
    assert all("mrr" in ln for ln in lines[1:]) and len(lines) > 1

    servers = []
    real_init = tserve.QueryServer.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        servers.append(self)

    monkeypatch.setattr(tserve.QueryServer, "__init__", init)
    tserve.main(["--run_dir", run, "--device", "cpu", "--requests", "3",
                 "--batch", "4", "--structures", "2-chain,2-inter"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["checkpoint"] == os.path.join(run, "ckpt", "step_4")
    (server,) = servers
    # the run dir's bibox_w is kept (the reference's serve CLI rebuilds
    # the config without it and would serve at 1.0)
    assert server.cfg.bibox_w == 0.5 and server.cfg.box_alpha == 0.02
    assert server._nbr is not None

    # the served answers equal the reference's evaluation path: its
    # QueryServer built in-process with the run's config and weights
    run_cfg = json.load(open(os.path.join(run, "config.json")))
    kg, _ = tev.load_run_data(run_cfg, "val")
    jkg = jsamp.make_random_kg(n_entities=120, n_modes=3, n_base_rels=6,
                               n_triples=400, seed=0)
    jt = jagg.build_neighbor_table_device(jkg, fanout=3, seed=0)
    params = convert.gqe_to_numpy(server.model)
    sampler = tsamp.QuerySampler(kg, seed=5)
    tqs = [q for s in ("2-chain", "3-inter_chain")
           for q in sampler.sample_queries(s, 4, n_neg=1)]
    jqs = [jsamp_query(q) for q in tqs]
    ids, sc = _served(server, tqs)
    for w, same in ((0.5, True), (1.0, False)):
        jcfg = jgqe.GQEConfig(**dict(mc, dtype=jnp.float32, bibox_w=w))
        with jax.default_matmul_precision("highest"):
            j_ids, j_sc = _served(JaxServer(
                jax.tree.map(jnp.asarray, params), jcfg, kg.entity_mode,
                neighbor_table=jt), jqs)
        if same:
            np.testing.assert_array_equal(ids, j_ids)
            np.testing.assert_allclose(sc, j_sc, rtol=0, atol=1e-5)
        else:
            assert np.abs(sc - j_sc).max() > 1e-3


def jsamp_query(q):
    """The JAX package's ``Query`` of a port ``Query``."""
    from mpqe_tpu.queries import Formula, Query

    f = q.formula
    return Query(Formula(f.structure, f.rels, f.node_modes), q.anchors,
                 q.target)


@pytest.mark.parametrize("decoder", ["transe", "distmult", "box"])
@pytest.mark.parametrize("intersection", ["min", "mean"])
def test_cli_trains_every_decoder_and_intersection(decoder, intersection,
                                                   tmp_path, capsys):
    from mpqe_tpu_torch.train.__main__ import main as train_main

    run = str(tmp_path / "run")
    state = train_main(CLI + ["--model", "gqe", "--decoder", decoder,
                              "--intersection", intersection,
                              "--gqe_encoder", "neighborhood",
                              "--gqe_aggregator", "max", "--steps", "3",
                              "--val_every", "3", "--run_dir", run])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"final step=3 macro_auc=\S+ macro_apr=\S+", last)
    assert isinstance(state.model, tgqe.GQE)
    assert state.model.nbr.w_combine.shape == (32, 16)


@pytest.mark.parametrize("flags,message", [
    (["--kernel", "fused"], "--kernel applies to --model rgcn only"),
    (["--shared_negatives", "4"], "--shared_negatives requires --model rgcn"),
    (["--self_adv_tau", "1.0"], "--self_adv_tau requires --model rgcn"),
])
def test_cli_gqe_refusals_match_the_reference(flags, message, tmp_path):
    from mpqe_tpu_torch.train.__main__ import main as train_main

    with pytest.raises(SystemExit, match=message):
        train_main(CLI + ["--model", "gqe", *flags, "--run_dir",
                          str(tmp_path / "r")])

