"""The port's data-parallel step with the entity table row-sharded
(``mpqe_tpu_torch/parallel/spmd.py``, ``parallel/sharding.py``) on the
CPU, against the JAX package's ``parallel/spmd.py`` (GSPMD on 8 of the
conftest's CPU devices) and against the port's single-device step.

* JAX: 3 steps of the spmd step on meshes ``(8, 1)`` and ``(4, 2)``,
  with and without ``shard_relations``, and of its multistep form,
  parameters carried across: losses within 1e-5 relative, parameters
  within 1e-5 absolute.  The optimizer is SGD there: Adam turns the sum
  order's last-bit gradient differences of near-zero elements into
  lr-sized steps (``tests/test_torch_port_multistep.py``).
* The port's single-device step: Adam with the global-norm clip, 3
  steps on ``(8, 1)``, ``(4, 2)`` and ``(2, 4)`` with a table whose row
  count the model axis does not divide and a batch with padded queries
  (the loss is the global batch's, not a mean of part means): losses and
  parameters within 1e-5.
* The halo step with the table sharded against it replicated, the
  checkpoint layout (the table whole, read by the unsharded code; the
  optimizer state an unsharded run's), the out-of-range id of the
  sharded gather against JAX's, and the train CLI's ``--parallel spmd``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.data.batcher import make_dense_batch
from mpqe_tpu.data.sampler import QuerySampler, make_random_kg
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.parallel import mesh as jmesh
from mpqe_tpu.parallel import rank_shard as jrs
from mpqe_tpu.parallel import spmd as jspmd
from mpqe_tpu.train import loop as jloop
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.data import pipeline as tpipe
from mpqe_tpu_torch.data.batcher import DenseQueryBatch
from mpqe_tpu_torch.models import embeddings as temb
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.parallel import halo_train as tht
from mpqe_tpu_torch.parallel import mesh as tmesh
from mpqe_tpu_torch.parallel import rank_shard as trs
from mpqe_tpu_torch.parallel import sharding as tsh
from mpqe_tpu_torch.parallel import spmd as tspmd
from mpqe_tpu_torch.train import checkpoint as tckpt
from mpqe_tpu_torch.train import loop as tloop

D = 16
TOL = 1e-5


def _jax_setting(n_real=16):
    """The reference's ``tests/test_parallel.py`` setting: a 128-entity
    KG, one 2-chain formula, a batch of 16 (``n_real`` real queries)."""
    kg = make_random_kg(n_entities=128, n_modes=2, n_base_rels=4,
                        n_triples=600, seed=21)
    sampler = QuerySampler(kg, seed=4)
    qs = sampler.sample_queries("2-chain", 40, n_neg=8)
    f = qs[0].formula
    qs = [q for q in qs if q.formula == f]
    while len(qs) < 16:
        q = sampler.sample_query("2-chain", n_neg=8)
        if q and q.formula == f:
            qs.append(q)
    kw = dict(n_entities=kg.n_entities, n_modes=kg.n_modes,
              n_rels=kg.n_rels, embed_dim=D, n_layers=2, num_bases=4,
              readout="tgt")
    batch = make_dense_batch(f, qs[:n_real], batch_size=16, n_neg=8)
    return jm.MPQEConfig(**kw), tm.MPQEConfig(**kw), batch


def _port_batch(b) -> DenseQueryBatch:
    return DenseQueryBatch(
        structure=b.structure, n_queries=b.n_queries,
        **{f: np.asarray(getattr(b, f)) for f in tloop.BATCH_FIELDS})


def _jax_named(tree):
    out = {"emb.ent": tree["emb"]["ent"], "emb.var": tree["emb"]["var"]}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            out[f"layers.{i}.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _params_close(model, want, tol=TOL):
    sd = model.state_dict()
    assert set(sd) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(sd[n].numpy(), w, rtol=0, atol=tol,
                                   err_msg=n)


def _put(mesh):
    return functools.partial(tspmd.put_batch, mesh)


@pytest.mark.parametrize("shape,relations,multistep", [
    ((8, 1), False, False), ((4, 2), False, False), ((4, 2), True, False),
    ((4, 2), True, True)], ids=["8x1", "4x2", "4x2-relations",
                                 "4x2-relations-multistep"])
def test_spmd_step_matches_jax(shape, relations, multistep):
    jcfg, tcfg, jb = _jax_setting(n_real=13)
    kw = dict(lr=0.02, optimizer="sgd", batch_size=16, n_neg=8)
    jtc, ttc = jloop.TrainConfig(**kw), tloop.TrainConfig(**kw)
    jm_ = jmesh.make_mesh(shape, devices=jax.devices()[:8])
    make = (jspmd.make_spmd_multistep_train_step if multistep
            else jspmd.make_spmd_train_step)
    init_fn, jstep = make(jcfg, jtc, jm_, shard_entity_table=True,
                          shard_relations=relations)
    params, opt = init_fn(jax.random.PRNGKey(5))
    model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    mesh = tmesh.make_mesh(shape, devices=["cpu"] * 8)
    state = tspmd.place_train_state(model, ttc, mesh,
                                    shard_entity_table=True,
                                    shard_relations=relations)
    tmake = (tspmd.make_spmd_multistep_train_step if multistep
             else tspmd.make_spmd_train_step)
    _, tstep = tmake(tcfg, ttc, mesh, shard_relations=relations)
    batch = _port_batch(jb)
    with jax.default_matmul_precision("highest"):
        if multistep:
            stacked = tpipe.stack_batches([batch] * 3)
            arrays = [jnp.asarray(getattr(stacked, f))
                      for f in tloop.BATCH_FIELDS]
            params, opt, jl = jstep(params, opt, jb.structure, *arrays)
            jl = [float(x) for x in jl]
            tl = tloop.run_multistep_stacked(tstep, state, stacked,
                                             _put(mesh))
        else:
            jl, tl = [], []
            for _ in range(3):
                params, opt, loss = jspmd.spmd_train_step(jstep, params, opt,
                                                          jm_, jb)
                jl.append(float(loss))
                tl.append(tspmd.spmd_train_step(tstep, state, mesh, batch))
    assert state.step == 3
    for a, b in zip(jl, tl):
        assert abs(a - b) <= TOL * abs(a), (jl, tl)
    _params_close(state.model, _jax_named(params))
    ent = state.model.emb.ent
    assert isinstance(ent, tsh.RowShardedTable)
    assert len(ent.blocks) == shape[1] and ent.block_rows == 128 // shape[1]


def _port_setting(n_entities=130):
    """The JAX setting's batch over a port model whose row count the model
    axis (2 or 4) does not divide."""
    _, tcfg, jb = _jax_setting(n_real=11)
    import dataclasses

    return dataclasses.replace(tcfg, n_entities=n_entities), _port_batch(jb)


@pytest.mark.parametrize("shape,relations", [
    ((8, 1), False), ((4, 2), True), ((2, 4), True)],
    ids=["8x1", "4x2-relations", "2x4-relations"])
def test_spmd_step_matches_single_device_step(shape, relations):
    tcfg, batch = _port_setting()
    tc = tloop.TrainConfig(lr=0.01, grad_clip_norm=0.5, weight_decay=1e-3,
                           batch_size=16, n_neg=8)
    single = tloop.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                    tc)
    one = tloop.make_train_step(tcfg, single.optimizer)
    mesh = tmesh.make_mesh(shape, devices=["cpu"] * 8)
    init_fn, step = tspmd.make_spmd_train_step(
        tcfg, tc, mesh, shard_relations=relations)
    state = init_fn(torch.Generator().manual_seed(0))
    for _ in range(3):
        la = tloop.run_step(one, single, batch)
        lb = tspmd.spmd_train_step(step, state, mesh, batch)
        assert abs(la - lb) <= TOL * abs(la), (la, lb)
    want = single.model.state_dict()
    got = state.model.state_dict()
    assert set(got) == set(want)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=TOL)
    # the moments are sharded like their leaves, and in the unsharded
    # layout equal the single-device optimizer's
    ent = state.model.emb.ent
    for b in ent.blocks:
        assert state.optimizer.state[b]["mu"].shape == b.shape
    osd = tsh.optimizer_state_dict(state.model, state.optimizer)
    wsd = single.optimizer.state_dict()
    assert osd["param_groups"][0]["count"] == 3
    assert sorted(osd["state"]) == sorted(wsd["state"])
    for i in wsd["state"]:
        for k in ("mu", "nu"):
            torch.testing.assert_close(osd["state"][i][k],
                                       wsd["state"][i][k], rtol=0, atol=TOL)


def test_spmd_multistep_equals_single_steps():
    tcfg, batch = _port_setting()
    tc = tloop.TrainConfig(lr=0.01, batch_size=16, n_neg=8)
    mesh = tmesh.make_mesh((4, 2), devices=["cpu"] * 8)
    init_fn, step = tspmd.make_spmd_train_step(tcfg, tc, mesh)
    _, mstep = tspmd.make_spmd_multistep_train_step(tcfg, tc, mesh)
    a = init_fn(torch.Generator().manual_seed(1))
    b = init_fn(torch.Generator().manual_seed(1))
    want = [tspmd.spmd_train_step(step, a, mesh, batch) for _ in range(3)]
    got = tloop.run_multistep(mstep, b, [batch] * 3, _put(mesh))
    assert got == want and b.step == 3
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_halo_step_with_sharded_table_matches_replicated():
    tcfg, batch = _port_setting()
    tc = tloop.TrainConfig(lr=0.02, batch_size=16, n_neg=8)
    mesh = tmesh.make_mesh((4, 2), devices=["cpu"] * 8)
    rep = tht.init_halo_train_state(torch.Generator().manual_seed(9), tcfg,
                                    tc, mesh)
    tp = tht.init_halo_train_state(torch.Generator().manual_seed(9), tcfg,
                                   tc, mesh, shard_entity_table=True)
    ent = tp.model.emb.ent
    assert isinstance(ent, tsh.RowShardedTable) and len(ent.blocks) == 2
    assert all(b.shape[0] < tcfg.n_entities for b in ent.blocks)
    s_rep = tht.make_halo_train_step(tcfg, rep.optimizer, mesh, "ring")
    s_tp = tht.make_halo_train_step(tcfg, tp.optimizer, mesh, "ring")
    for _ in range(2):
        la = tloop.run_step(s_rep, rep, batch)
        lb = tloop.run_step(s_tp, tp, batch)
        assert abs(la - lb) <= TOL * abs(la), (la, lb)
    want, got = rep.model.state_dict(), tp.model.state_dict()
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=TOL)


def test_checkpoint_holds_the_table_whole(tmp_path):
    tcfg, batch = _port_setting()
    tc = tloop.TrainConfig(lr=0.01, batch_size=16, n_neg=8)
    mesh = tmesh.make_mesh((2, 4), devices=["cpu"] * 8)
    init_fn, step = tspmd.make_spmd_train_step(tcfg, tc, mesh)
    state = init_fn(torch.Generator().manual_seed(3))
    for _ in range(2):
        tspmd.spmd_train_step(step, state, mesh, batch)
    path = tckpt.save_checkpoint(str(tmp_path), state)
    payload = torch.load(os.path.join(path, tckpt.STATE_FILE),
                         weights_only=True)
    assert tuple(payload["model"]["emb.ent"].shape) == (130, D)
    assert not any("blocks" in k for k in payload["model"])
    # read by the unsharded code: model and optimizer
    plain = tloop.init_train_state(torch.Generator().manual_seed(7), tcfg,
                                   tc)
    tckpt.restore_checkpoint(path, plain)
    assert plain.step == 2
    sd = state.model.state_dict()
    for n, p in plain.model.state_dict().items():
        assert torch.equal(p, sd[n]), n
    # ... and its next step equals the sharded run's
    one = tloop.make_train_step(tcfg, plain.optimizer)
    la = tloop.run_step(one, plain, batch)
    lb = tspmd.spmd_train_step(step, state, mesh, batch)
    assert abs(la - lb) <= TOL * abs(la)
    # resume: a fresh sharded state splits the table and moments again
    again = init_fn(torch.Generator().manual_seed(8))
    tckpt.restore_checkpoint(path, again)
    sd2 = again.model.state_dict()
    for n in sd:
        assert sd2[n].shape == sd[n].shape
    assert again.optimizer.param_groups[0]["count"] == 2
    lc = tspmd.spmd_train_step(step, again, mesh, batch)
    assert lc == lb


def test_out_of_range_ids_follow_the_sharded_reference():
    """The reference's sharded paths gather from the padded table: an id
    in [n, n_pad) reads a zero pad row and one past the padding clamps to
    the last (pad) row; the unsharded gather clamps to row n - 1.  Pinned
    against JAX's ``shard_encode_params`` table on a 4-part model axis,
    row for row and through the per-query-relation encoder."""
    n = 109
    kw = dict(n_entities=n, n_modes=3, n_rels=6, embed_dim=D, n_layers=2,
              num_bases=None, readout="tgt")
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(0), jcfg)
    jm_ = jmesh.make_mesh((1, 4), devices=jax.devices()[:4])
    p_sh = jrs.shard_encode_params(dict(params), jm_)
    model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    mesh = tmesh.make_mesh((1, 4), devices=["cpu"] * 4)
    sharded = trs.shard_encode_params(model, mesh)
    ids = np.array([0, 5, 108, 109, 110, 111, 112, 500], np.int32)
    want = np.asarray(p_sh["emb"]["ent"][jnp.asarray(ids)])
    got = temb.entity_rows(sharded.emb.ent,
                           torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[3:].any()  # pad rows
    plain = temb.entity_rows(model.emb.ent,
                             torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_array_equal(plain[3:], np.repeat(plain[2:3], 5, 0))
    rng = np.random.default_rng(0)
    from mpqe_tpu_torch.queries import STRUCTURES

    spec = STRUCTURES["2-inter"]
    B = 8
    ne = rng.integers(0, n, (B, spec.n_nodes)).astype(np.int32)
    ne[:4, spec.anchor_slots[0]] = [109, 111, 200, 108]
    nm = rng.integers(0, 3, (B, spec.n_nodes)).astype(np.int32)
    er = rng.integers(0, 6, (B, spec.n_edges)).astype(np.int32)
    en = np.ones((B, spec.n_edges), np.float32)
    with jax.default_matmul_precision("highest"):
        jq = np.asarray(jm.encode_dense_multi(p_sh, jcfg, "2-inter",
                                              *map(jnp.asarray,
                                                   (ne, nm, er, en))))
    tq = tm.encode_dense_multi(sharded, tcfg, "2-inter",
                               *map(torch.from_numpy, (ne, nm, er, en)))
    np.testing.assert_allclose(tq.detach().numpy(), jq, rtol=0, atol=1e-5)



def test_relation_sharded_state_evaluates_and_serves():
    """A state of the spmd step with ``shard_relations`` (each layer's
    ``coeff`` row-sharded) goes through K3's operands (its plain version
    here): ``evaluate_batched``, ``full_ranking_sharded`` and
    ``ShardedQueryServer`` give exactly the answers of the same
    parameters unsharded; ``full_ranking``, ``QueryServer`` and a
    quantized ``ShardedQueryServer`` refuse the sharded table rather than
    assemble it."""
    from mpqe_tpu_torch.data.sampler import QuerySampler, make_random_kg
    from mpqe_tpu_torch.queries import group_queries_by_formula
    from mpqe_tpu_torch.serve import QueryServer, ShardedQueryServer
    from mpqe_tpu_torch.train import evaluation as tev

    kg = make_random_kg(n_entities=121, n_modes=3, n_base_rels=4,
                        n_triples=700, seed=2)
    tcfg = tm.MPQEConfig(n_entities=kg.n_entities, n_modes=kg.n_modes,
                         n_rels=kg.n_rels, embed_dim=D, n_layers=2,
                         num_bases=4, readout="tgt")
    tc = tloop.TrainConfig(lr=0.01, batch_size=16, n_neg=8)
    mesh = tmesh.make_mesh((2, 4), devices=["cpu"] * 8)
    init_fn, _ = tspmd.make_spmd_train_step(tcfg, tc, mesh,
                                            shard_relations=True)
    state = init_fn(torch.Generator().manual_seed(4))
    assert isinstance(state.model.layers[0].coeff, tsh.RowShardedTable)
    plain = tloop.init_train_state(torch.Generator().manual_seed(5), tcfg,
                                   tc).model
    plain.load_state_dict(state.model.state_dict())
    s = QuerySampler(kg, seed=3)
    val = group_queries_by_formula(
        s.sample_queries("2-chain", 20, n_neg=8)
        + s.sample_queries("3-chain_inter", 20, n_neg=8))
    es = tev.make_eval_set(val)
    assert (tev.evaluate_batched(state.model, tcfg, es).flat()
            == tev.evaluate_batched(plain, tcfg, es).flat())
    assert (tev.full_ranking_sharded(state.model, tcfg, val,
                                     kg.entity_mode, mesh)
            == tev.full_ranking(plain, tcfg, val, kg.entity_mode))
    with pytest.raises(ValueError, match="full_ranking_sharded"):
        tev.full_ranking(state.model, tcfg, val, kg.entity_mode)
    qs = [q for st in ("1-chain", "2-inter") for q in
          s.sample_queries(st, 4, n_neg=1)]
    got = ShardedQueryServer(state.model, tcfg, kg.entity_mode,
                             mesh).answer(qs, k=5)
    want = QueryServer(plain, tcfg, kg.entity_mode,
                       device="cpu").answer(qs, k=5)
    with pytest.raises(ValueError, match="ShardedQueryServer"):
        QueryServer(state.model, tcfg, kg.entity_mode, device="cpu")
    with pytest.raises(ValueError, match="pass the model unsharded"):
        ShardedQueryServer(state.model, tcfg, kg.entity_mode, mesh,
                           table_dtype="int8")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.entity_ids, b.entity_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


# --------------------------------------------------------------------- CLI
CLI = ["--device", "cpu", "--embed_dim", "16", "--num_bases", "4",
       "--batch_size", "16", "--n_neg", "4", "--syn_entities", "201",
       "--syn_triples", "800", "--syn_train_queries", "140",
       "--syn_val_queries", "28"]


@pytest.mark.parametrize("extra", [[], ["--steps_per_call", "2",
                                        "--prefetch", "2"]],
                         ids=["single", "multistep_prefetch"])
def test_train_cli_spmd_on_cpu(extra, tmp_path, capsys):
    from mpqe_tpu_torch import evaluate as tev
    from mpqe_tpu_torch import serve as tserve
    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "run")
    main(CLI + ["--parallel", "spmd", "--mesh", "2,2", "--steps", "6",
                "--val_every", "3", "--run_dir", run] + extra)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("final step=6 macro_auc=")
    lines = [json.loads(ln) for ln in open(os.path.join(run,
                                                        "metrics.jsonl"))]
    assert {"event": "mesh", "shape": {"data": 2, "model": 2}}.items() <= \
        next(ln for ln in lines if ln.get("event") == "mesh").items()
    payload = torch.load(os.path.join(run, "ckpt", "step_6",
                                      tckpt.STATE_FILE), weights_only=True)
    assert tuple(payload["model"]["emb.ent"].shape) == (201, 16)
    # the unsharded evaluate and serve CLIs read the run
    tev.main(["--run_dir", run, "--device", "cpu", "--ranking"])
    out = [json.loads(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]
    assert out[0]["step"] == 6 and all("mrr" in ln for ln in out[1:])
    tserve.main(["--run_dir", run, "--device", "cpu", "--requests", "3",
                 "--batch", "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["checkpoint"].endswith("step_6")
    # --resume splits the table again and trains on
    main(CLI + ["--parallel", "spmd", "--mesh", "2,2", "--steps", "4",
                "--val_every", "3", "--run_dir", run, "--resume"] + extra)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "final step=10 ")


@pytest.mark.parametrize("n", [8, 6, 4, 1])
def test_dryrun_multichip(n, capsys):
    """``python -m mpqe_tpu_torch.tools.dryrun_multichip`` on the CPU: the
    spmd step with both tables sharded, the four halo layers, K8 (plain)
    against the ring, a halo train step and the sharded rank / top-k."""
    from mpqe_tpu_torch.tools import dryrun_multichip as dr

    out = dr.main(["--n_devices", str(n), "--device", "cpu"])
    m = 2 if n % 2 == 0 else 1
    assert out["mesh"] == {"data": n // m, "model": m}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip ok: mesh={out['mesh']} loss=")
    assert np.isfinite(out["loss"]) and out["k8_err"] <= 1e-4
