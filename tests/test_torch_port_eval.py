"""The port's per-formula evaluation slice against the JAX package on the
CPU: ``make_dense_batch`` and ``dense_to_sparse`` (array for array),
``evaluate`` through the default dense encoder and through a sparse
adapter (``dense_to_sparse`` then ``encode_sparse``; the port's with
``segment_backend="pallas"``, the reference's with ``"xla"``, which is
what its CPU backend can run), ``full_ranking``, ``run_train`` with
``eval_encode_fn``, and the ``python -m mpqe_tpu_torch.evaluate`` CLI.

Tolerances: the batches are exact; the same queries get the same
negatives, so per-structure AUC and APR agree to 1e-4 (scores are f32 on
both sides and differ only in sum order, which moves an AUC only where a
positive and a negative tie to ~1e-7); full ranking on a full-weight
model (both sides' f32 per-query-relation encoder) to 1e-4 as well.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.data import batcher as jbatch
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.queries import STRUCTURE_NAMES
from mpqe_tpu.queries import group_queries_by_formula as jgroup
from mpqe_tpu.train import evaluation as jeval
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.data import batcher as tbatch
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import segment_kernels as tsk
from mpqe_tpu_torch.queries import group_queries_by_formula as tgroup
from mpqe_tpu_torch.train import evaluation as teval
from mpqe_tpu_torch.train import loop as tloop

KG = dict(n_entities=300, n_modes=3, n_base_rels=6, n_triples=3000, seed=3)
D = 16


def _kgs_and_queries(n_val=6, seed=3, n_neg=16):
    jkg, tkg = jsamp.make_random_kg(**KG), tsamp.make_random_kg(**KG)
    js, ts = jsamp.QuerySampler(jkg, seed=seed), tsamp.QuerySampler(
        tkg, seed=seed)
    jq, tq = [], []
    for s in STRUCTURE_NAMES:
        jq += js.sample_queries(s, n_val, n_neg=n_neg)
        tq += ts.sample_queries(s, n_val, n_neg=n_neg)
    return jkg, tkg, jgroup(jq), tgroup(tq)


def _models(kg, nb=4, readout="tgt", seed=1):
    kw = dict(n_entities=kg.n_entities, n_modes=kg.n_modes, n_rels=kg.n_rels,
              embed_dim=D, n_layers=3, num_bases=nb, readout=readout)
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:  # non-zero biases (init is zeros)
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _assert_batches_equal(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(a, b, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f


DENSE_FIELDS = ("node_entity", "node_mode", "edge_rel", "edge_norm",
                "target", "negatives", "neg_mask", "query_mask")


# -------------------------------------------------------------- batches
@pytest.mark.parametrize("use_hard", [False, True])
def test_make_dense_batch_matches_jax(use_hard):
    _, _, jq, tq = _kgs_and_queries(n_val=10)
    for s in STRUCTURE_NAMES:
        (jf, jqs), (tf, tqs) = (max(d[s].items(), key=lambda kv: len(kv[1]))
                                for d in (jq, tq))
        assert jf.rels == tf.rels and len(jqs) == len(tqs)
        for B, n_neg in ((None, 3), (32, 40)):
            kw = dict(batch_size=B, n_neg=n_neg, use_hard_negatives=use_hard)
            jb = jbatch.make_dense_batch(jf, jqs, **kw)
            tb = tbatch.make_dense_batch(tf, tqs, **kw)
            _assert_batches_equal(tb, jb, DENSE_FIELDS)
            assert (tb.structure, tb.n_queries, tb.used_hard,
                    tb.batch_size) == (jb.structure, jb.n_queries,
                                       jb.used_hard, jb.batch_size)
            # an explicit generator is drawn from in the same order
            jb = jbatch.make_dense_batch(jf, jqs, rng=np.random.default_rng(9),
                                         **kw)
            tb = tbatch.make_dense_batch(tf, tqs, rng=np.random.default_rng(9),
                                         **kw)
            np.testing.assert_array_equal(tb.negatives, jb.negatives)
    with pytest.raises(ValueError, match="empty"):
        tbatch.make_dense_batch(tf, [])
    with pytest.raises(ValueError, match="batch_size"):
        tbatch.make_dense_batch(tf, tqs, batch_size=len(tqs) - 1)


@pytest.mark.parametrize("capacity", [None, 200])
def test_dense_to_sparse_matches_jax(capacity):
    jkg, _, jq, tq = _kgs_and_queries(n_val=10)
    for s in STRUCTURE_NAMES:
        (jf, jqs), (tf, tqs) = (next(iter(d[s].items())) for d in (jq, tq))
        jsb = jbatch.dense_to_sparse(
            jbatch.make_dense_batch(jf, jqs, n_neg=2), jkg.n_rels, capacity)
        tsb = tbatch.dense_to_sparse(
            tbatch.make_dense_batch(tf, tqs, n_neg=2), jkg.n_rels, capacity)
        _assert_batches_equal(tsb, jsb, (
            "node_entity", "node_mode", "node_is_var", "node_query",
            "target_node", "target", "negatives", "neg_mask", "query_mask"))
        _assert_batches_equal(tsb.edges, jsb.edges,
                              ("src", "dst", "rel", "norm", "rel_ptr"))
        assert (tsb.structure, tsb.n_queries, tsb.n_nodes,
                tsb.edges.n_edges, tsb.edges.capacity) == (
            jsb.structure, jsb.n_queries, jsb.n_nodes, jsb.edges.n_edges,
            jsb.edges.capacity)


# --------------------------------------------------- encode_fn adapters
_jax_encode_sparse = jax.jit(jm.encode_sparse, static_argnums=(1, 2),
                             static_argnames=("n_queries",))


def jax_sparse_encode(params, cfg, structure, ne, nm, er, en):
    """The reference's sparse encoder behind ``evaluate``'s ``encode_fn``
    (``"xla"`` segments: its ``"pallas"`` kernels need a TPU)."""
    B = ne.shape[0]
    z = np.zeros(B, np.int32)
    b = jbatch.DenseQueryBatch(structure, B, np.asarray(ne), np.asarray(nm),
                               np.asarray(er), np.asarray(en), z,
                               z[:, None], np.ones((B, 1), np.float32),
                               np.ones(B, np.float32))
    sb = jbatch.dense_to_sparse(b, cfg.n_rels)
    e = sb.edges
    return _jax_encode_sparse(
        params, cfg, structure, *map(jnp.asarray, (
            sb.node_entity, sb.node_mode, sb.node_is_var, e.src, e.dst,
            e.rel, e.norm, sb.node_query, sb.target_node)), n_queries=B)


class SparseEncode:
    """The port's adapter: ``dense_to_sparse`` then ``encode_sparse``
    with the ``"pallas"`` segment backend (K4a / K4b); counts its calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, model, cfg, structure, ne, nm, er, en):
        B = ne.shape[0]
        z = np.zeros(B, np.int32)
        b = tbatch.DenseQueryBatch(
            structure, B, *(t.cpu().numpy() for t in (ne, nm, er, en)), z,
            z[:, None], np.ones((B, 1), np.float32), np.ones(B, np.float32))
        sb = tbatch.dense_to_sparse(b, cfg.n_rels)
        e = sb.edges
        self.calls.append(structure)
        return tm.encode_sparse(
            model, cfg, structure, *(torch.from_numpy(a).to(ne.device) for a
                                     in (sb.node_entity, sb.node_mode,
                                         sb.node_is_var, e.src, e.dst, e.rel,
                                         e.norm, sb.node_query,
                                         sb.target_node)), B,
            segment_backend="pallas")


def _assert_results_close(tres, jres, tol):
    for a, b in ((jres.auc_by_structure, tres.auc_by_structure),
                 (jres.apr_by_structure, tres.apr_by_structure),
                 (jres.hard_auc_by_structure, tres.hard_auc_by_structure)):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k])
    assert set(jres.flat()) == set(tres.flat())


# ------------------------------------------------------------ evaluate
@pytest.mark.parametrize("adapter,readout,n_val", [
    ("dense", "tgt", 6), ("sparse", "tgt", 3), ("sparse", "max", 3)])
def test_evaluate_matches_jax(adapter, readout, n_val):
    # the sparse adapter runs one small encode per formula: fewer queries
    # keep it quick (the readouts are held one by one in
    # test_torch_port_segment.py)
    jkg, _, jq, tq = _kgs_and_queries(n_val=n_val)
    jcfg, tcfg, params, model = _models(jkg, readout=readout)
    if adapter == "dense":
        j_fn, t_fn = None, None
    else:
        j_fn = jax_sparse_encode
        t_fn = SparseEncode()
    with jax.default_matmul_precision("highest"):
        jres = jeval.evaluate(params, jcfg, jq, n_neg=16, encode_fn=j_fn)
    tres = teval.evaluate(model, tcfg, tq, n_neg=16, encode_fn=t_fn)
    _assert_results_close(tres, jres, 1e-4)
    if t_fn is not None:
        # one encode per formula and one more per intersection formula
        # with hard negatives
        assert len(t_fn.calls) >= sum(len(v) for v in tq.values())


def test_evaluate_sparse_and_dense_agree():
    # the port's two encoders on the same queries: dense f32 vs sparse
    # through the plain K4 (the card check gates the same at 1e-3)
    _, tkg, _, tq = _kgs_and_queries(n_val=3)
    _, tcfg, _, model = _models(tkg)
    a = teval.evaluate(model, tcfg, tq)
    b = teval.evaluate(model, tcfg, tq, encode_fn=SparseEncode())
    _assert_results_close(a, b, 1e-4)


def test_evaluate_and_full_ranking_refuse_other_configs():
    # the per-formula protocol is MPQE's only, as the reference's is; the
    # full ranking takes a GQE model; a config of no model raises
    from mpqe_tpu_torch.models import gqe as tgqe

    _, tkg, _, tq = _kgs_and_queries(n_val=1)
    cfg = tgqe.GQEConfig(n_entities=tkg.n_entities, n_modes=tkg.n_modes,
                         n_rels=tkg.n_rels, embed_dim=D, decoder="box")
    model = tgqe.init_gqe(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="evaluate_batched"):
        teval.evaluate(model, cfg, tq)
    rk = teval.full_ranking(model, cfg, tq, tkg.entity_mode)
    assert set(rk) == set(tq)
    for m in rk.values():
        assert 0.0 < m["mrr"] <= 1.0 and m["mean_rank"] >= 1.0

    class OtherConfig:
        pass

    for fn in (teval.evaluate, teval.full_ranking):
        with pytest.raises(TypeError, match="OtherConfig"):
            fn(model, OtherConfig(), tq, tkg.entity_mode)


@pytest.mark.parametrize("max_batch", [8192, 5])
def test_full_ranking_matches_jax(max_batch):
    # a full-weight model: both sides encode in f32 (a basis model takes
    # K3's bf16 plain version in the port, the f32 encoder in JAX's CPU
    # backend); max_batch 5 splits each structure into padded chunks
    jkg, tkg, jq, tq = _kgs_and_queries(n_val=12)
    jcfg, tcfg, params, model = _models(jkg, nb=None)
    with jax.default_matmul_precision("highest"):
        want = jeval.full_ranking(params, jcfg, jq, jkg.entity_mode,
                                  hits_at=(1, 3, 10), max_batch=max_batch)
    got = teval.full_ranking(model, tcfg, tq, tkg.entity_mode,
                             hits_at=(1, 3, 10), max_batch=max_batch)
    assert set(got) == set(want)
    for s in want:
        assert set(got[s]) == set(want[s]) == {
            "mrr", "mean_rank", "hits@1", "hits@3", "hits@10"}
        for k in want[s]:
            assert abs(got[s][k] - want[s][k]) <= 1e-4 * max(
                1.0, abs(want[s][k])), (s, k, got[s][k], want[s][k])
    np.testing.assert_array_equal(
        list(teval._rank_metrics(np.array([1.0, 2.0, 7.0, 30.0]),
                                 (1, 10)).values()),
        list(jeval._rank_metrics(np.array([1.0, 2.0, 7.0, 30.0]),
                                 (1, 10)).values()))


# ---------------------------------------------------- run_train and CLI
def test_run_train_validates_through_eval_encode_fn(monkeypatch):
    _, tkg, _, tq = _kgs_and_queries(n_val=2, n_neg=8)
    tsampler = tsamp.QuerySampler(tkg, seed=11)
    train_q = tgroup([q for s in STRUCTURE_NAMES
                      for q in tsampler.sample_queries(s, 6, n_neg=8)])
    _, tcfg, _, model = _models(tkg)
    tc = tloop.TrainConfig(lr=0.01, batch_size=16, n_neg=2, max_steps=4,
                           val_every=2, burn_in_structure="none", seed=0)
    state = tloop.TrainState(model, tloop.make_optimizer(
        tc, model.parameters()))

    def no_batched(*a, **k):
        raise AssertionError("the batched sweep ran")

    monkeypatch.setattr(teval, "evaluate_batched", no_batched)
    enc = SparseEncode()
    records = []
    tloop.run_train(state, tcfg, tc, train_q, val_queries=tq,
                    log_fn=records.append, eval_encode_fn=enc, kg=tkg)
    vals = [r for r in records if "val" in r]
    assert [r["step"] for r in vals] == [2, 4]
    assert enc.calls and set(enc.calls) <= set(STRUCTURE_NAMES)
    want = teval.evaluate(state.model, tcfg, tq, encode_fn=SparseEncode())
    assert vals[-1]["val"] == want.flat()


def _tiny_run(tmp_path):
    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "run")
    main(["--device", "cpu", "--embed_dim", "16", "--n_layers", "2",
          "--num_bases", "4", "--batch_size", "16", "--n_neg", "2",
          "--syn_entities", "120", "--syn_triples", "400",
          "--syn_train_queries", "70", "--syn_val_queries", "28",
          "--steps", "4", "--val_every", "2", "--run_dir", run])
    return run


def test_evaluate_cli_on_cpu(tmp_path, capsys):
    from mpqe_tpu_torch import evaluate as tev
    from mpqe_tpu_torch.serve import config_from_json
    from mpqe_tpu_torch.train import checkpoint as tckpt

    run = _tiny_run(tmp_path)
    capsys.readouterr()
    tev.main(["--run_dir", run, "--device", "cpu", "--ranking",
              "--hits_at", "1,5"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    head, ranks = lines[0], lines[1:]
    run_cfg = json.load(open(os.path.join(run, "config.json")))
    kg, val_q = tev.load_run_data(run_cfg, "val")
    cfg = config_from_json(json.load(open(os.path.join(
        run, "model_config.json"))))
    state = tckpt.restore_checkpoint(
        tckpt.latest_checkpoint(os.path.join(run, "ckpt")),
        tloop.init_train_state(torch.Generator().manual_seed(5), cfg,
                               tloop.TrainConfig()))
    res = teval.evaluate_batched(state.model, cfg,
                                 teval.make_eval_set(val_q))
    assert head == {"checkpoint": os.path.join(run, "ckpt", "step_4"),
                    "step": 4, "use": "val", **res.flat()}
    assert [r["ranking"] for r in ranks] == list(val_q)
    for r in ranks:
        assert set(r) == {"ranking", "mrr", "mean_rank", "hits@1", "hits@5"}

    # --use test: a fresh draw from the disjoint seed, as the reference's
    jkg = jsamp.make_random_kg(n_entities=120, n_modes=3, n_base_rels=6,
                               n_triples=400, seed=0)
    jsampler = jsamp.QuerySampler(jkg, seed=7919)
    _, test_q = tev.load_run_data(run_cfg, "test")
    per_s = max(1, 28 // len(val_q))
    want = [q for s in val_q for q in jsampler.sample_queries(s, per_s,
                                                              n_neg=64)]
    got = [q for by_f in test_q.values() for qs in by_f.values() for q in qs]
    assert sorted((q.formula.rels, q.anchors, q.target) for q in got) == \
        sorted((q.formula.rels, q.anchors, q.target) for q in want)
    tev.main(["--run_dir", run, "--device", "cpu", "--use", "test"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["use"] == "test" and "auc_macro" in line


def test_evaluate_cli_refuses_unported(tmp_path, capsys):
    from mpqe_tpu_torch import evaluate as tev

    run = _tiny_run(tmp_path)
    # --shards is ported: the sharded ranking gives the unsharded lines
    capsys.readouterr()
    tev.main(["--run_dir", run, "--device", "cpu", "--ranking"])
    want = capsys.readouterr().out.strip().splitlines()
    tev.main(["--run_dir", run, "--device", "cpu", "--ranking", "--shards",
              "2"])
    assert capsys.readouterr().out.strip().splitlines() == want
    # --split is ported: one bucket line per non-empty bucket, their n
    # adding up to the evaluated queries (all seen: one bucket)
    capsys.readouterr()
    tev.main(["--run_dir", run, "--device", "cpu", "--split"])
    head, *buckets = [json.loads(ln) for ln in
                      capsys.readouterr().out.strip().splitlines()]
    run_cfg = json.load(open(os.path.join(run, "config.json")))
    _, val_q = tev.load_run_data(run_cfg, "val")
    n_val = sum(len(qs) for by_f in val_q.values() for qs in by_f.values())
    assert "auc_macro" in head
    assert [(b["bucket"], b["n"]) for b in buckets] == [("seen_edges",
                                                         n_val)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tev.main(["--run_dir", run])
    # a GQE run dir is evaluated, its neighbor table rebuilt from the run
    from mpqe_tpu_torch.train.__main__ import main

    gqe_run = str(tmp_path / "gqe")
    main(["--device", "cpu", "--model", "gqe", "--decoder", "transe",
          "--gqe_encoder", "neighborhood", "--gqe_fanout", "3",
          "--embed_dim", "16", "--batch_size", "16", "--n_neg", "2",
          "--syn_entities", "120", "--syn_triples", "400",
          "--syn_train_queries", "70", "--syn_val_queries", "28",
          "--steps", "2", "--val_every", "2", "--run_dir", gqe_run])
    capsys.readouterr()
    tev.main(["--run_dir", gqe_run, "--device", "cpu", "--ranking"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["step"] == 2 and "auc_macro" in lines[0]
    assert len(lines) > 1 and all("mrr" in ln for ln in lines[1:])
    # a GQE run gets the reference's refusal of the sharded ranking
    with pytest.raises(ValueError, match="MPQE configs only"):
        tev.main(["--run_dir", gqe_run, "--device", "cpu", "--ranking",
                  "--shards", "2"])
    capsys.readouterr()
    tev.main(["--run_dir", gqe_run, "--device", "cpu", "--split"])
    buckets = [json.loads(ln) for ln in
               capsys.readouterr().out.strip().splitlines()][1:]
    assert [b["bucket"] for b in buckets] == ["seen_edges"]
    assert all("auc_macro" in b for b in buckets)


def test_segment_launches_stay_zero_on_the_cpu():
    # the CPU path never touches the kernels' counters
    before = (tsk.segment_sum_kernel.launches,
              tsk.segment_max_kernel.launches)
    _, tkg, _, tq = _kgs_and_queries(n_val=1)
    _, tcfg, _, model = _models(tkg, readout="max")
    teval.evaluate(model, tcfg, tq, encode_fn=SparseEncode())
    assert (tsk.segment_sum_kernel.launches,
            tsk.segment_max_kernel.launches) == before
