"""``ShardedQueryServer`` and ``full_ranking_sharded`` of the port on the
CPU (parts on ``["cpu"] * 8``), mirroring ``tests/test_serve_sharded.py``:

* against the JAX package's ``ShardedQueryServer`` on a ``(2, 4)`` mesh
  of the conftest's CPU devices, for a full-weight model (f32 encoders
  on both sides): ids equal, scores within 1e-5 (f32 sum order), the
  ``(-inf, -1)`` tail where a mode is scarce;
* for a basis model the port encodes through K3 (its plain version
  here) from a compact anchor table gathered from the owner blocks:
  bit-equal to the unsharded K3 on the same requests, and the sharded
  server's answers equal the unsharded server's (ids equal, scores
  within 1e-6);
* the GQE refusal, the HTTP front end over the sharded server, the
  quantized tables' recall, the protocol evaluation unchanged by
  sharding, ``full_ranking_sharded`` against ``full_ranking`` rank for
  rank, and ``--shards`` in the serve and evaluate CLIs.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mpqe_tpu.data.sampler import QuerySampler as JSampler
from mpqe_tpu.data.sampler import make_random_kg as jkg
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.parallel import mesh as jmesh
from mpqe_tpu.serve import ShardedQueryServer as JShardedServer
from mpqe_tpu_torch import queries as tq
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.data.sampler import QuerySampler, make_random_kg
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import fused_fwd as tff
from mpqe_tpu_torch.parallel import mesh as tmesh
from mpqe_tpu_torch.parallel import rank_shard as trs
from mpqe_tpu_torch.parallel import sharding as tsh
from mpqe_tpu_torch.serve import QueryServer, ShardedQueryServer
from mpqe_tpu_torch.train import evaluation as tev

# 151 entities: not divisible by 4 parts, the row padding
KG = dict(n_entities=151, n_modes=3, n_base_rels=4, n_triples=900, seed=6)
STRUCTS = ("1-chain", "2-chain", "2-inter", "3-chain_inter")


def _model(num_bases, seed=0):
    kg = jkg(**KG)
    kw = dict(n_entities=kg.n_entities, n_modes=kg.n_modes,
              n_rels=kg.n_rels, embed_dim=16, n_layers=2,
              num_bases=num_bases, readout="tgt")
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _mesh():
    return tmesh.make_mesh((2, 4), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def kg():
    return make_random_kg(**KG)


@pytest.fixture(scope="module")
def basis(kg):
    """A basis model (K3-eligible) served unsharded and sharded."""
    _, tcfg, _, model = _model(num_bases=2)
    return (tcfg, model, QueryServer(model, tcfg, kg.entity_mode,
                                     device="cpu"),
            ShardedQueryServer(model, tcfg, kg.entity_mode, _mesh()))


def _sample(kg, seed, structures=STRUCTS, n=5):
    s = QuerySampler(kg, seed=seed)
    return [q for st in structures for q in s.sample_queries(st, n, n_neg=1)]


def _port_query(q):
    f = q.formula
    return tq.Query(tq.Formula(f.structure, f.rels, f.node_modes),
                    q.anchors, q.target)


def _stack(answers):
    return (np.stack([a.entity_ids for a in answers]),
            np.stack([a.scores for a in answers]))


def test_sharded_matches_jax_sharded_server(kg):
    jcfg, tcfg, params, model = _model(num_bases=None)
    jmsh = jmesh.make_mesh((2, 4), devices=jax.devices()[:8])
    js = JSampler(jkg(**KG), seed=2)
    jqs = [q for st in STRUCTS for q in js.sample_queries(st, 5, n_neg=1)]
    with jax.default_matmul_precision("highest"):
        j_ids, j_sc = _stack(JShardedServer(params, jcfg, kg.entity_mode,
                                            jmsh).answer(jqs, k=7))
    server = ShardedQueryServer(model, tcfg, kg.entity_mode, _mesh())
    t_ids, t_sc = _stack(server.answer([_port_query(q) for q in jqs], k=7))
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-5)
    # no pad row (ids >= n_entities) and the target's mode everywhere
    assert t_ids.max() < kg.n_entities
    for q, ids in zip(jqs, t_ids):
        t_mode = q.formula.node_modes[q.formula.spec.target_slot]
        assert (kg.entity_mode[ids] == t_mode).all()


def test_sharded_k_exceeding_mode_population(kg):
    """More answers than the rarest mode has entities: the tail is
    ``(-inf, -1)``, as JAX's sharded server returns it."""
    jcfg, tcfg, params, model = _model(num_bases=None, seed=1)
    counts = np.bincount(kg.entity_mode, minlength=kg.n_modes)
    rare = int(np.argmin(counts))
    js = JSampler(jkg(**KG), seed=4)
    q = next(qq for qq in (js.sample_query("1-chain", n_neg=1)
                           for _ in range(200))
             if qq.formula.node_modes[1] == rare)
    k = int(counts[rare]) + 3
    jmsh = jmesh.make_mesh((2, 4), devices=jax.devices()[:8])
    with jax.default_matmul_precision("highest"):
        ja = JShardedServer(params, jcfg, kg.entity_mode, jmsh).answer(
            [q], k=k)[0]
    a = ShardedQueryServer(model, tcfg, kg.entity_mode, _mesh()).answer(
        [_port_query(q)], k=k)[0]
    finite = np.isfinite(a.scores)
    assert finite.sum() == counts[rare]
    assert (a.entity_ids[~finite] == -1).all()
    np.testing.assert_array_equal(a.entity_ids, np.asarray(ja.entity_ids))


def test_k3_from_the_compact_anchor_table_is_bit_equal(kg, basis):
    """K3 over the row-sharded table (a compact table of each call's
    anchor rows) gives the unsharded K3's bits."""
    tcfg, model, dense, sharded = basis
    for structure in STRUCTS:
        req = _sample(kg, 11, (structure,), n=9)
        _, *arrays = dense._pack(req)
        args = [torch.from_numpy(a) for a in arrays[:4]]
        assert tm.multi_kernel_eligible(tcfg, structure)
        with torch.no_grad():
            want = tff.fused_tgt_forward_multi(
                dense.model, tcfg, structure, *args, operands=dense._k3)
            got = tff.fused_tgt_forward_multi(
                sharded.model, tcfg, structure, *args, operands=sharded._k3)
        assert torch.equal(got, want), structure
    # the unsharded server passes the model's own table, with no copy
    assert dense._k3.ent.data_ptr() == dense.model.emb.ent.data_ptr()
    assert isinstance(sharded._k3.ent, tsh.RowShardedTable)


def test_sharded_server_matches_unsharded_server(kg, basis):
    _, _, dense, sharded = basis
    req = _sample(kg, 2)
    d_ids, d_sc = _stack(dense.answer(req, k=7))
    s_ids, s_sc = _stack(sharded.answer(req, k=7))
    np.testing.assert_array_equal(s_ids, d_ids)
    np.testing.assert_allclose(s_sc, d_sc, rtol=0, atol=1e-6)
    # the per-part score rows cap the batch (151 / 4 rows a part)
    assert sharded.max_batch == 8192 and dense.max_batch == 8192


def test_sharded_rejects_gqe(kg):
    from mpqe_tpu_torch.models import gqe as tgqe

    cfg = tgqe.GQEConfig(n_entities=kg.n_entities, n_modes=kg.n_modes,
                         n_rels=kg.n_rels, embed_dim=16, decoder="bilinear",
                         intersection="deepsets")
    model = tgqe.init_gqe(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="MPQE"):
        ShardedQueryServer(model, cfg, kg.entity_mode, _mesh())
    with pytest.raises(ValueError, match="MPQE"):
        tev.full_ranking_sharded(model, cfg, {}, kg.entity_mode, _mesh())


def test_sharded_serves_over_http(kg, basis):
    """netserve needs only ``answer`` and ``max_batch``: the sharded
    server plugs into the HTTP front end unchanged."""
    from mpqe_tpu_torch.netserve import make_http_server

    _, _, dense, sharded = basis
    srv = make_http_server(sharded, kg, "127.0.0.1", 0, default_k=5,
                           max_wait_ms=1.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        q = QuerySampler(kg, seed=5).sample_query("2-chain", n_neg=1)
        req = urllib.request.Request(
            url + "/v1/answer",
            data=json.dumps({"queries": [{
                "structure": "2-chain", "anchors": list(q.anchors),
                "rels": list(q.formula.rels)}]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        wire = body["answers"][0]
        direct = dense.answer([q], k=5)[0]
        assert wire["entities"] == [int(e) for e in direct.entity_ids]
    finally:
        srv.shutdown()
        srv.batcher.stop()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sharded_quantized_table_recall(kg, basis, dtype):
    """The quantized per-part tables keep the ranking close to the f32
    sharded server's (the reference's recall rule)."""
    tcfg, model, _, sharded = basis
    qt = ShardedQueryServer(model, tcfg, kg.entity_mode, _mesh(),
                            table_dtype=dtype)
    if dtype == "int8":  # blocks padded to a multiple of 8 rows
        assert all(t.shape[0] == 40 for t in qt._tables)
    qs = QuerySampler(kg, seed=7).sample_queries("2-chain", 20, n_neg=1)
    a_f = sharded.answer(qs, k=10)
    a_q = qt.answer(qs, k=10)
    overlaps = [len(set(f.entity_ids.tolist()) & set(q.entity_ids.tolist()))
                / 10 for f, q in zip(a_f, a_q)]
    assert np.mean(overlaps) >= 0.8
    for f, q in zip(a_f, a_q):
        np.testing.assert_allclose(q.scores[np.isfinite(q.scores)],
                                   f.scores[np.isfinite(f.scores)],
                                   atol=0.05)
    assert qt.table_bytes < sharded.table_bytes


def test_protocol_eval_and_ranking_are_sharding_transparent(kg, basis):
    """``evaluate_batched`` over a model whose table is row-sharded equals
    the unsharded result exactly (its gathers go to the owner blocks),
    and ``full_ranking_sharded`` gives ``full_ranking``'s ranks."""
    from mpqe_tpu_torch.queries import group_queries_by_formula

    tcfg, model, _, _ = basis
    s = QuerySampler(kg, seed=12)
    val = group_queries_by_formula(
        s.sample_queries("2-chain", 30, n_neg=8)
        + s.sample_queries("2-inter", 30, n_neg=8, n_hard_neg=8))
    dense = tev.evaluate_batched(model, tcfg, tev.make_eval_set(val))
    sharded_model = trs.shard_encode_params(model, _mesh())
    sharded = tev.evaluate_batched(sharded_model, tcfg,
                                   tev.make_eval_set(val))
    assert dense.flat() == sharded.flat()
    want = tev.full_ranking(model, tcfg, val, kg.entity_mode)
    got = tev.full_ranking_sharded(model, tcfg, val, kg.entity_mode,
                                   _mesh())
    assert got == want
    assert isinstance(model.emb.ent, torch.nn.Parameter)  # not changed


# --------------------------------------------------------------------- CLI
def test_shards_in_the_serve_and_evaluate_clis(tmp_path, capsys,
                                               monkeypatch):
    from mpqe_tpu_torch import evaluate as tev_cli
    from mpqe_tpu_torch import serve as tserve
    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "run")
    main(["--device", "cpu", "--embed_dim", "16", "--n_layers", "2",
          "--num_bases", "4", "--batch_size", "16", "--n_neg", "2",
          "--syn_entities", "121", "--syn_triples", "400",
          "--syn_train_queries", "70", "--syn_val_queries", "28",
          "--steps", "4", "--val_every", "2", "--run_dir", run])
    capsys.readouterr()
    tev_cli.main(["--run_dir", run, "--device", "cpu", "--ranking"])
    want = capsys.readouterr().out.strip().splitlines()
    tev_cli.main(["--run_dir", run, "--device", "cpu", "--ranking",
                  "--shards", "3"])
    assert capsys.readouterr().out.strip().splitlines() == want
    for dtype in ("float32", "int8"):
        tserve.main(["--run_dir", run, "--device", "cpu", "--requests", "4",
                     "--batch", "3", "--shards", "2", "--table_dtype",
                     dtype])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["shards"] == 2 and rec["table_dtype"] == dtype
        # 121 rows: 2 blocks of 61 (f32, d = 16) or of 64 (int8)
        assert rec["table_bytes"] == {"float32": 2 * 61 * 16 * 4,
                                      "int8": 2 * 64 * 16}[dtype]
    # on the card, N parts need N distinct cards: never a repeated one
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--shards 2 needs that many "
                                         "devices, have 1"):
        tmesh.cli_mesh((1, 2), torch.device("cuda"), "--shards 2")
