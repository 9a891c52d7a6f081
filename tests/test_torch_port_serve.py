"""The PyTorch port's ``QueryServer`` (``device="cpu"``, K3's plain
version) against the JAX package's ``QueryServer`` on a tiny KG.

* Tight: with the JAX encoder routed through the Pallas K3 kernel in
  interpret mode (a test-side patch; the JAX package is unchanged), the
  two servers return identical ids and top-k scores within 1e-4.
* Loose: against the unpatched JAX server (f32 encoder on the CPU) the
  scores agree within 1e-2 (bf16 operands); ids are not compared, since
  near-ties swap under bf16.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpqe_tpu.models.mpqe as jm
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data.torch_import import export_mpqe_state_dict
from mpqe_tpu.ops import pallas_fused_fwd as jff
from mpqe_tpu.queries import STRUCTURE_NAMES
from mpqe_tpu.serve import QueryServer as JaxServer
from mpqe_tpu_torch import convert, queries as tq
from mpqe_tpu_torch import serve as tserve
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import fused_fwd as tff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KG = dict(n_entities=300, n_modes=4, n_base_rels=6, n_triples=2000, seed=0)
K = 10


def _cfgs():
    kw = dict(n_entities=300, n_modes=4, n_rels=12, embed_dim=16,
              n_layers=3, num_bases=4)
    return jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)


def _params(seed=0, dup_rows=None):
    jcfg, tcfg = _cfgs()
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    if dup_rows is not None:  # copy one entity's row onto others
        src, dsts = dup_rows
        ent = np.array(params["emb"]["ent"])
        ent[dsts] = ent[src]
        params["emb"]["ent"] = jnp.asarray(ent)
    model = convert.model_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     "cpu")
    return jcfg, tcfg, params, model


def _queries(n_per=5, seed=7):
    """The same sampled queries from both packages' samplers."""
    jq = jsamp.QuerySampler(jsamp.make_random_kg(**KG), seed=seed)
    tqs = tsamp.QuerySampler(tsamp.make_random_kg(**KG), seed=seed)
    a, b = [], []
    for s in STRUCTURE_NAMES:
        a += jq.sample_queries(s, n_per, n_neg=1)
        b += tqs.sample_queries(s, n_per, n_neg=1)
    order = np.random.default_rng(seed).permutation(len(a))  # mix them
    return [a[i] for i in order], [b[i] for i in order], tqs.kg.entity_mode


@pytest.fixture
def interpret_k3(monkeypatch):
    """Route the JAX servers' encoder through the Pallas K3 kernel in
    interpret mode (it otherwise takes the f32 path on the CPU)."""
    def auto(params, cfg, structure, ne, nm, er, en):
        return jff.fused_tgt_forward_multi(params, cfg, structure, ne, nm,
                                           er, en, block=8, interpret=True)

    monkeypatch.setattr(jm, "encode_dense_multi_auto", auto)


def _answers(server, queries, k=K):
    out = server.answer(queries, k=k)
    return (np.stack([a.entity_ids for a in out]),
            np.stack([a.scores for a in out]))


def _port_query(q):
    f = q.formula
    return tq.Query(tq.Formula(f.structure, f.rels, f.node_modes),
                    q.anchors, q.target)


def test_server_matches_jax_k3_tightly(interpret_k3):
    jcfg, tcfg, params, model = _params()
    jqs, tqs, mode = _queries()
    with jax.default_matmul_precision("highest"):
        j_ids, j_sc = _answers(JaxServer(params, jcfg, mode), jqs)
    before = tff.fused_tgt_forward_multi.launches
    t_ids, t_sc = _answers(tserve.QueryServer(model, tcfg, mode,
                                              device="cpu"), tqs)
    assert tff.fused_tgt_forward_multi.launches == before  # plain on CPU
    assert t_ids.dtype == np.int32 and t_sc.dtype == np.float32
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-4)


def test_server_matches_jax_f32_loosely():
    jcfg, tcfg, params, model = _params(seed=1)
    jqs, tqs, mode = _queries(seed=8)
    with jax.default_matmul_precision("highest"):
        _, j_sc = _answers(JaxServer(params, jcfg, mode), jqs)
    _, t_sc = _answers(tserve.QueryServer(model, tcfg, mode, device="cpu"),
                       tqs)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-2)


def test_top_k_follows_lax_tie_order():
    rows = [[1, 3, 3, -np.inf, -np.inf, 3]]
    rng = np.random.default_rng(0)
    rows += rng.integers(-3, 3, (50, 40)).tolist()  # many ties
    x = np.asarray(rows[1:], np.float32)
    x[x == -3] = -np.inf
    for arr, k in ((np.asarray(rows[:1], np.float32), 5), (x, 10), (x, 40),
                   (x, 1)):
        want_v, want_i = jax.lax.top_k(jnp.asarray(arr), k)
        got_v, got_i = tserve.top_k(torch.from_numpy(arr), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    got = tserve.top_k(torch.tensor([[1., 3., 3., -np.inf, -np.inf, 3.]]), 5)
    assert got[1].tolist() == [[1, 2, 5, 0, 3]]


def _sparse_mode_case():
    """Mode 3 keeps 4 entities (fewer than k); queries target it."""
    _, tqs, mode = _queries()
    mode = mode.copy()
    m3 = np.flatnonzero(mode == 3)
    mode[m3[4:]] = 2
    qs = [q for q in tqs if q.formula.structure == "1-chain"][:3]
    picked = []
    for q in qs:
        f = q.formula
        modes = f.node_modes[:-1] + (3,)
        picked.append(tq.Query(tq.Formula(f.structure, f.rels, modes),
                               q.anchors, q.target))
    return picked, mode


def _as_jax(queries):
    from mpqe_tpu import queries as jqmod

    return [jqmod.Query(jqmod.Formula(q.formula.structure, q.formula.rels,
                                      q.formula.node_modes),
                        q.anchors, q.target) for q in queries]


def test_sparse_mode_and_duplicate_rows_match_lax_order(interpret_k3):
    picked, mode = _sparse_mode_case()
    # duplicate rows: entity 5's row copied onto four others of its mode
    same = np.flatnonzero(mode == mode[5])[1:5]
    jcfg, tcfg, params, model = _params(dup_rows=(5, same))
    _, tqs, _ = _queries()
    queries = picked + tqs[:12]
    with jax.default_matmul_precision("highest"):
        j_ids, j_sc = _answers(JaxServer(params, jcfg, mode),
                               _as_jax(queries))
    t_ids, t_sc = _answers(tserve.QueryServer(model, tcfg, mode,
                                              device="cpu"), queries)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-4)
    # the sparse mode's tail is -inf, ids ascending among the -inf
    for i in range(len(picked)):
        assert np.isfinite(t_sc[i, :4]).all() and np.isneginf(t_sc[i, 4:]).all()
        assert (np.diff(t_ids[i, 4:]) > 0).all()


def test_answers_have_the_target_mode_and_no_padding_leaks():
    _, tcfg, _, model = _params(seed=2)
    _, tqs, mode = _queries(seed=9)
    server = tserve.QueryServer(model, tcfg, mode, device="cpu")
    ids, sc = _answers(server, tqs)
    assert ids.shape == (len(tqs), K)
    for q, row, s in zip(tqs, ids, sc):
        ok = np.isfinite(s)
        assert (mode[row[ok]] == q.formula.target_mode).all()
        assert (np.diff(s) <= 0).all()
    # three queries of one structure (bucket 16, 13 padded rows) give the
    # same answers as inside a full mixed batch
    three = [q for q in tqs if q.formula.structure == "3-chain"][:3]
    idx = [tqs.index(q) for q in three]
    ids3, sc3 = _answers(server, three)
    np.testing.assert_array_equal(ids3, ids[idx])
    np.testing.assert_array_equal(sc3, sc[idx])


def test_server_refusals():
    _, tcfg, _, model = _params()
    mode = np.zeros(300, np.int32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.QueryServer(model, tcfg, mode)  # device=None is the card
    for dtype, torch_dtype in (("bfloat16", torch.bfloat16),
                               ("int8", torch.int8)):
        server = tserve.QueryServer(model, tcfg, mode, table_dtype=dtype,
                                    device="cpu")
        assert server._ent_norm_t.dtype == torch_dtype
    with pytest.raises(ValueError, match="cosine scoring"):
        tserve.QueryServer(model, dataclasses.replace(tcfg,
                                                      scale_scores=False),
                           mode, table_dtype="int8", device="cpu")
    with pytest.raises(ValueError):
        tserve.QueryServer(model, tcfg, mode, table_dtype="fp8",
                           device="cpu")
    # GQE models are served (tests/test_torch_port_gqe_train.py holds
    # them to JAX); a neighborhood model needs its table
    from mpqe_tpu_torch.models import gqe as tgqe

    mc = {"n_entities": 300, "n_modes": 4, "n_rels": 12, "embed_dim": 16,
          "decoder": "bibox", "intersection": "min", "soft_and": True,
          "encoder": "neighborhood", "bibox_w": 0.25,
          "dtype": "torch.float32"}
    gcfg = tserve.config_from_json(mc)
    assert gcfg == tgqe.GQEConfig(
        n_entities=300, n_modes=4, n_rels=12, embed_dim=16, decoder="bibox",
        intersection="min", soft_and=True, encoder="neighborhood",
        bibox_w=0.25)
    gmodel = tgqe.init_gqe(torch.Generator().manual_seed(0), gcfg)
    with pytest.raises(ValueError, match="need neighbor_table="):
        tserve.QueryServer(gmodel, gcfg, mode, device="cpu")
    table = {"idx": torch.zeros((300, 2), dtype=torch.int32),
             "mask": torch.ones((300, 2))}
    server = tserve.QueryServer(gmodel, gcfg, mode, device="cpu",
                                neighbor_table=table)
    assert server.max_batch == 8192 and server._nbr is not None
    for spelling in ("bfloat16", "torch.bfloat16",
                     "<class 'jax.numpy.bfloat16'>"):
        assert tserve.config_from_json(
            dict(mc, dtype=spelling)).dtype == torch.bfloat16


def test_max_batch_cap_matches_jax():
    from mpqe_tpu.train.evaluation import _effective_max_batch as jeff
    from mpqe_tpu_torch.train.evaluation import _effective_max_batch as teff

    for n in (300, 1_000_000, 10_000_000):
        for mb in (1, 256, 8192):
            assert teff(None, mb, n) == jeff(None, mb, n)


def _cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "mpqe_tpu_torch.serve",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, **kw)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_serves_a_random_model():
    out = _cli(["--device", "cpu", "--init_seed", "0", "--syn_entities",
                "200", "--syn_triples", "1500", "--requests", "6",
                "--batch", "3", "--structures", "1-chain,2-inter,3-chain"])
    for key in ("latency_ms_p50", "latency_ms_p95", "queries_per_s",
                "hit_at_k"):
        assert key in out
    assert out["device"] == "cpu" and out["requests"] == 6


def test_cli_serves_a_jax_checkpoint(tmp_path, capsys):
    syn = dict(n_entities=200, n_modes=3, n_base_rels=6, n_triples=1500,
               seed=0)
    jcfg = jm.MPQEConfig(n_entities=200, n_modes=3, n_rels=12, embed_dim=16,
                         n_layers=2, num_bases=3)
    params = jm.init_mpqe(jax.random.PRNGKey(3), jcfg)
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in export_mpqe_state_dict(params).items()},
               tmp_path / "model.pt")
    mc = dict(n_entities=200, n_modes=3, n_rels=12, embed_dim=16, n_layers=2,
              num_bases=3, readout="tgt", margin=1.0, scale_scores=True,
              dtype="float32")
    (tmp_path / "model_config.json").write_text(json.dumps(mc))
    tserve.main(["--device", "cpu", "--model_config",
                 str(tmp_path / "model_config.json"), "--state_dict",
                 str(tmp_path / "model.pt"), "--syn_entities",
                 str(syn["n_entities"]), "--syn_modes", "3",
                 "--syn_triples", "1500", "--requests", "5", "--batch", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["checkpoint"].endswith("model.pt")
    assert 0.0 <= out["hit_at_k"] <= 1.0


TRAIN_CLI = ["--device", "cpu", "--data", "synthetic", "--embed_dim", "16",
             "--n_layers", "2", "--num_bases", "4", "--batch_size", "16",
             "--n_neg", "2", "--syn_entities", "120", "--syn_triples", "400",
             "--syn_train_queries", "70", "--syn_val_queries", "28",
             "--steps", "3", "--val_every", "3"]


def test_cli_serves_a_run_dir(tmp_path, capsys, monkeypatch):
    from mpqe_tpu_torch import evaluate as tev
    from mpqe_tpu_torch.train import checkpoint as tckpt
    from mpqe_tpu_torch.train.__main__ import main as train_main

    run = str(tmp_path / "run")
    train_main(TRAIN_CLI + ["--run_dir", run])
    capsys.readouterr()
    served = []  # (queries, answers) of every request the CLI answered
    real_answer = tserve.QueryServer.answer

    def answer(self, queries, k=10):
        out = real_answer(self, queries, k=k)
        served.append((list(queries), out))
        return out

    monkeypatch.setattr(tserve.QueryServer, "answer", answer)
    tserve.main(["--run_dir", run, "--device", "cpu", "--requests", "4",
                 "--structures", "1-chain,2-inter,3-chain"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ckpt = os.path.join(run, "ckpt", "step_3")
    assert out["checkpoint"] == ckpt == tckpt.latest_checkpoint(
        os.path.join(run, "ckpt"))
    assert out["requests"] == 4 and out["device"] == "cpu"
    monkeypatch.setattr(tserve.QueryServer, "answer", real_answer)

    # the same requests through a server over the model restored from the
    # same state.pt, by hand
    run_cfg = json.load(open(os.path.join(run, "config.json")))
    kg, _ = tev.load_run_data(run_cfg, "val")
    cfg = tserve.config_from_json(json.load(open(os.path.join(
        run, "model_config.json"))))
    model = tm.MPQE(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(ckpt, "state.pt"),
                                     weights_only=True)["model"])
    server = tserve.QueryServer(model, cfg, kg.entity_mode, device="cpu")
    requests = served[-4:]  # after the warmup's
    hits = 0
    for queries, answers in requests:
        want = server.answer(queries, k=10)
        for q, a, w in zip(queries, answers, want):
            np.testing.assert_array_equal(a.entity_ids, w.entity_ids)
            np.testing.assert_array_equal(a.scores, w.scores)
            hits += int(q.target in w.entity_ids.tolist())
    assert out["hit_at_k"] == hits / sum(len(q) for q, _ in requests)


def test_cli_model_source_flags_are_exclusive(tmp_path, capsys):
    for flags in (["--run_dir", str(tmp_path), "--init_seed", "0"],
                  ["--run_dir", str(tmp_path), "--state_dict", "m.pt"],
                  ["--init_seed", "0", "--ckpt", str(tmp_path)],
                  ["--run_dir", str(tmp_path), "--model_config", "m.json"],
                  []):
        with pytest.raises(SystemExit) as e:
            tserve.main(["--device", "cpu", *flags])
        assert e.value.code == 2, flags  # argparse's usage error
    assert "usage" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="no checkpoint"):
        (tmp_path / "config.json").write_text(json.dumps({"seed": 0}))
        (tmp_path / "model_config.json").write_text(json.dumps(dict(
            n_entities=3, n_modes=1, n_rels=2, embed_dim=4, n_layers=1,
            num_bases=None, readout="tgt")))
        tserve.main(["--device", "cpu", "--run_dir", str(tmp_path)])
