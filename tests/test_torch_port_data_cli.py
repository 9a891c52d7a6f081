"""The port's data path through its entry points, against the JAX package
on the CPU: ``python -m mpqe_tpu_torch.tools.prepare_dataset`` against
``tools/prepare_dataset.py``, the train CLI's ``load_data`` (``synthetic``,
``npz:``, ``pkl:``) against ``train.load_data``, the raw-edge 1-chain
stores of a ``pkl:`` dataset without ``train_edges.pkl``, ``evaluate
--split`` and ``--use test``, ``serve --answer`` against the JAX
``QueryServer`` and ``tools/quality_bench.py``'s ``build_data``.

Data and queries are compared exactly (numpy and Python on both sides).
Served scores: within 1e-5 (f32 on both sides, another sum order), with
equal ids; models whose encoder is float32 on both sides (full
per-relation weights, and a GQE bilinear head).  Sizes are the JAX tests'
(``tests/test_rdf.py``: ``make_random_kg(120, 3 modes, 4 relations, 900
triples)``; rule KGs of <= 150 entities).
"""

import argparse
import contextlib
import gzip
import importlib.util
import io
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

import train as jtrain_cli
from mpqe_tpu.data import loader as jload
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data import store as jstore
from mpqe_tpu.data.rdf import RDF_TYPE
from mpqe_tpu.models import gqe as jgqe
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.serve import QueryServer as JaxServer
from mpqe_tpu_torch import convert
from mpqe_tpu_torch import evaluate as tev
from mpqe_tpu_torch import serve as tserve
from mpqe_tpu_torch.data import loader as tload
from mpqe_tpu_torch.data import native as tnative
from mpqe_tpu_torch.tools import prepare_dataset as tprep
from mpqe_tpu_torch.tools import quality_bench as tqb
from mpqe_tpu_torch.train import __main__ as ttrain_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KG_FIELDS = ("entity_mode", "rel_domain", "rel_range", "heads", "rels",
             "tails")
PREP = ["--train_per_structure", "40", "--eval_per_structure", "8",
        "--n_neg", "8", "--seed", "3"]
TRAIN = ["--device", "cpu", "--embed_dim", "16", "--n_layers", "2",
         "--num_bases", "4", "--batch_size", "16", "--n_neg", "2",
         "--seed", "1"]


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def qkey(q):
    f = q.formula
    return (f.structure, f.rels, f.node_modes, q.anchors, q.target,
            q.neg_samples, q.hard_neg_samples)


def grouped_keys(grouped):
    return {s: [((f.structure, f.rels, f.node_modes),
                 [qkey(q) for q in qs]) for f, qs in by_f.items()]
            for s, by_f in grouped.items()}


def assert_kgs_equal(a, b):
    for f in KG_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.n_entities, a.n_base_rels, a.mode_names, a.rel_names) == (
        b.n_entities, b.n_base_rels, b.mode_names, b.rel_names)


def _write_nt(path):
    """``tests/test_rdf.py``'s synthetic KG as gzipped N-Triples."""
    kg = jsamp.make_random_kg(n_entities=120, n_modes=3, n_base_rels=4,
                              n_triples=900, seed=7)
    lines = [f"<http://s/e{e:04d}> <{RDF_TYPE}> <http://s/M{int(m)}> ."
             for e, m in enumerate(kg.entity_mode)]
    lines += [f"<http://s/e{int(h):04d}> <http://s/r{int(r)}> "
              f"<http://s/e{int(t):04d}> ."
              for h, r, t in zip(kg.heads, kg.rels, kg.tails)]
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """(nt path, the port tool's dir, the JAX tool's dir) of one input."""
    root = tmp_path_factory.mktemp("prepared")
    nt = str(root / "kg.nt.gz")
    _write_nt(nt)
    with contextlib.redirect_stdout(io.StringIO()):
        tprep.main(["--nt", nt, "--out", str(root / "port"), *PREP])
        _jax_tool("prepare_dataset").main(
            ["--nt", nt, "--out", str(root / "jax"), *PREP])
    return nt, str(root / "port"), str(root / "jax")


def _train_args(mod, data, extra=()):
    return mod.parse_args(["--data", data, *extra])


# --------------------------------------------------------- prepare_dataset
def test_prepare_dataset_matches_the_jax_tool(prepared):
    _, port, ref = prepared
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names
    assert {"graph_data.pkl", "kg.npz", "kg_full.npz", "dataset.json",
            "train_edges.pkl", "val_edges.pkl", "test_edges.pkl",
            "train_queries_2.pkl", "train_queries_3.pkl",
            "val_queries_2.pkl", "val_queries_3.pkl", "test_queries_2.pkl",
            "test_queries_3.pkl"} <= set(names)
    jkg, jmodes, jrels = jload.load_graph_pickle(f"{ref}/graph_data.pkl")
    tkg, tmodes, trels = jload.load_graph_pickle(f"{port}/graph_data.pkl")
    assert_kgs_equal(tkg, jkg)
    assert (tmodes, list(trels.items())) == (jmodes, list(jrels.items()))
    for name in names:
        if name.endswith(".npz"):
            assert_kgs_equal(jload.load_kg_npz(f"{port}/{name}"),
                             jload.load_kg_npz(f"{ref}/{name}"))
        elif name.endswith(".json"):
            assert json.load(open(f"{port}/{name}")) == \
                json.load(open(f"{ref}/{name}"))
        elif name != "graph_data.pkl":
            assert grouped_keys(jload.load_queries_pickle(
                f"{port}/{name}", jkg)) == grouped_keys(
                jload.load_queries_pickle(f"{ref}/{name}", jkg)), name
            # the pickles themselves are byte-equal
            assert open(f"{port}/{name}", "rb").read() == \
                open(f"{ref}/{name}", "rb").read(), name


def test_prepare_dataset_from_npz_matches(tmp_path):
    kg = jsamp.make_rule_kg(n_entities=150, n_modes=3, n_base_rels=6,
                            out_degree=2, seed=0)
    npz = str(tmp_path / "kg.npz")
    jload.save_kg_npz(npz, kg)
    args = ["--npz", npz, "--train_per_structure", "10",
            "--eval_per_structure", "4", "--n_neg", "4", "--seed", "1"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tprep.main(args + ["--out", str(tmp_path / "port")])
        _jax_tool("prepare_dataset").main(args + ["--out",
                                                  str(tmp_path / "jax")])
    assert "python -m mpqe_tpu_torch.train --data pkl:" in out.getvalue()
    jkg, _, _ = jload.load_graph_pickle(str(tmp_path / "jax/graph_data.pkl"))
    for name in sorted(os.listdir(tmp_path / "jax")):
        if name.endswith(".pkl") and name != "graph_data.pkl":
            assert grouped_keys(jload.load_queries_pickle(
                str(tmp_path / "port" / name), jkg)) == grouped_keys(
                jload.load_queries_pickle(str(tmp_path / "jax" / name),
                                          jkg)), name


# ------------------------------------------------------------- load_data
def test_load_data_matches_for_every_source(prepared, tmp_path):
    _, port, _ = prepared
    npz = str(tmp_path / "kg.npz")
    tload.save_kg_npz(npz, jsamp.make_random_kg(n_entities=150, n_modes=3,
                                                n_base_rels=5, n_triples=600,
                                                seed=2))
    syn = ["--syn_entities", "120", "--syn_triples", "400",
           "--syn_train_queries", "70", "--syn_val_queries", "28"]
    for data, extra in (("synthetic", syn), (f"npz:{npz}", syn[4:]),
                        (f"pkl:{port}", ())):
        jkg, jtr, jva = jtrain_cli.load_data(_train_args(jtrain_cli, data,
                                                         extra))
        tkg, ttr, tva = ttrain_cli.load_data(_train_args(ttrain_cli, data,
                                                         extra))
        assert_kgs_equal(tkg, jkg)
        assert grouped_keys(ttr) == grouped_keys(jtr), data
        assert grouped_keys(tva) == grouped_keys(jva), data
    with pytest.raises(ValueError, match="unknown --data csv:x"):
        ttrain_cli.load_data(_train_args(ttrain_cli, "csv:x"))


def _without_train_edges(src, dst):
    shutil.copytree(src, dst)
    os.remove(os.path.join(dst, "train_edges.pkl"))
    return dst


@pytest.mark.parametrize("structures", ["all", "chains", "2-chain,2-inter"])
def test_raw_edge_stores_match_the_jax_derivation(prepared, tmp_path,
                                                  structures):
    _, port, _ = prepared
    d = _without_train_edges(port, str(tmp_path / "noedges"))
    targs = _train_args(ttrain_cli, f"pkl:{d}", ["--structures", structures])
    tkg, ttr, _ = ttrain_cli.load_data(targs)
    got = ttrain_cli.raw_edge_stores(targs, tkg, ttr)
    if structures == "2-chain,2-inter":  # no 1-chain wanted: none derived
        assert got is None
        return
    jkg, jtr, _ = jtrain_cli.load_data(_train_args(jtrain_cli, f"pkl:{d}"))
    # train.py's derivation (train.py:427-441)
    want = jstore.build_stores(jtr, kg=jkg)
    want.update(jstore.stores_from_edges(jkg))
    assert list(got) == list(want)
    for s in want:
        for a, b in zip(got[s], want[s], strict=True):
            assert (a.formula.structure, a.formula.rels,
                    a.formula.node_modes) == (
                b.formula.structure, b.formula.rels, b.formula.node_modes)
            for f in ("anchors", "targets", "neg_pool", "neg_ptr",
                      "fallback_pool", "ans_pool", "ans_ptr", "ans_idx"):
                x, y = getattr(a, f), getattr(b, f)
                if y is None:
                    assert x is None
                else:
                    np.testing.assert_array_equal(x, y, f)
    assert sum(s.n_queries for s in got["1-chain"]) == 2 * tkg.n_triples
    # a dataset that ships train_edges.pkl keeps its own 1-chain queries
    pargs = _train_args(ttrain_cli, f"pkl:{port}")
    pkg, ptr, _ = ttrain_cli.load_data(pargs)
    assert ttrain_cli.raw_edge_stores(pargs, pkg, ptr) is None


# ---------------------------------------------------- train / evaluate
@pytest.fixture(scope="module")
def pkl_run(prepared, tmp_path_factory):
    """A 6-step ``--data pkl:`` run dir of the train CLI, with its final
    line."""
    _, port, _ = prepared
    run = str(tmp_path_factory.mktemp("runs") / "pkl")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ttrain_cli.main(TRAIN + ["--data", f"pkl:{port}", "--steps", "6",
                                 "--val_every", "3", "--run_dir", run])
    return run, out.getvalue().strip().splitlines()[-1]


def _events(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_train_cli_on_a_pkl_dataset(pkl_run, prepared):
    run, last = pkl_run
    assert re.fullmatch(r"final step=6 macro_auc=\S+ macro_apr=\S+", last)
    events = _events(run)
    loaded = [e for e in events if e.get("event") == "data_loaded"]
    assert loaded and loaded[0]["data"] == f"pkl:{prepared[1]}"
    assert not any(e.get("event") == "raw_edge_1chain_derived"
                   for e in events)
    assert {"step_3", "step_6"} <= set(os.listdir(os.path.join(run, "ckpt")))


def test_train_cli_derives_raw_edge_stores(prepared, tmp_path):
    _, port, _ = prepared
    d = _without_train_edges(port, str(tmp_path / "noedges"))
    run = str(tmp_path / "run")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ttrain_cli.main(TRAIN + ["--data", f"pkl:{d}", "--steps", "3",
                                 "--val_every", "3", "--run_dir", run])
    assert out.getvalue().strip().splitlines()[-1].startswith(
        "final step=3 ")
    derived = [e["edge_queries"] for e in _events(run)
               if e.get("event") == "raw_edge_1chain_derived"]
    meta = json.load(open(os.path.join(d, "dataset.json")))
    assert derived == [2 * meta["train_triples"]]


def _cli_lines(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        main(argv)
    return [json.loads(ln) for ln in out.getvalue().strip().splitlines()]


@pytest.mark.parametrize("use", ["val", "test"])
def test_evaluate_split_buckets_match_the_jax_split(pkl_run, prepared, use):
    run, _ = pkl_run
    _, port, _ = prepared
    lines = _cli_lines(tev.main, ["--run_dir", run, "--device", "cpu",
                                  "--split", "--use", use])
    head, buckets = lines[0], lines[1:]
    assert head["use"] == use and head["step"] == 6
    jkg, _, _ = jload.load_graph_pickle(f"{port}/graph_data.pkl")
    jq = jload.load_split_queries(port, jkg, use)
    flat = [q for by_f in jq.values() for qs in by_f.values() for q in qs]
    seen, new = jload.split_one_new_edge(flat, jkg)
    want = [(name, len(b)) for name, b in (("seen_edges", seen),
                                           ("one_new_edge", new)) if b]
    assert [(b["bucket"], b["n"]) for b in buckets] == want
    assert sum(b["n"] for b in buckets) == len(flat)
    # held-out edges are new to the train graph: both buckets show up
    assert [b["bucket"] for b in buckets] == ["seen_edges", "one_new_edge"]
    for b in buckets:
        assert np.isfinite(b["auc_macro"]) and "apr_macro" in b


def test_evaluate_use_test_reads_the_test_split(pkl_run, prepared, tmp_path):
    run, _ = pkl_run
    _, port, _ = prepared
    run_cfg = json.load(open(os.path.join(run, "config.json")))
    _, got = tev.load_run_data(run_cfg, "test")
    jkg, _, _ = jload.load_graph_pickle(f"{port}/graph_data.pkl")
    assert grouped_keys(got) == grouped_keys(
        jload.load_split_queries(port, jkg, "test"))
    # a dataset without test files: the reference's exit
    d = str(tmp_path / "notest")
    shutil.copytree(port, d)
    for name in os.listdir(d):
        if name.startswith("test_"):
            os.remove(os.path.join(d, name))
    with pytest.raises(SystemExit, match="no test_"):
        tev.load_run_data(dict(run_cfg, data=f"pkl:{d}"), "test")


# ---------------------------------------------------------- serve --answer
@pytest.mark.parametrize("model", ["mpqe", "gqe"])
def test_serve_answer_matches_the_jax_server(prepared, tmp_path, model,
                                             monkeypatch):
    _, port, _ = prepared
    # the model this exact comparison was written for: its batches come
    # from the numpy packer (the C++ one draws another random stream)
    monkeypatch.setattr(tnative, "available", lambda: False)
    run = str(tmp_path / "run")
    flags = (["--num_bases", "0"] if model == "mpqe"
             else ["--model", "gqe", "--decoder", "bilinear"])
    with contextlib.redirect_stdout(io.StringIO()):
        ttrain_cli.main(TRAIN + flags + ["--data", f"pkl:{port}", "--steps",
                                         "3", "--val_every", "3",
                                         "--run_dir", run])
    out = str(tmp_path / "answers.npz")
    pkl = f"{port}/test_queries_3.pkl"
    line = _cli_lines(tserve.main, ["--run_dir", run, "--device", "cpu",
                                    "--answer", pkl, "--out", out])[-1]
    got = np.load(out)
    # the same queries through the JAX QueryServer on the same parameters
    run_cfg, mc = tev.read_run_dir(run)
    cfg = tserve.config_from_json(mc)
    _, _, tmodel = tev.restore_model(run, cfg, None, "cpu")
    jkg, _, _ = jload.load_graph_pickle(f"{port}/graph_data.pkl")
    grouped = jload.load_queries_pickle(pkl, jkg)
    flat = [q for by_f in grouped.values() for qs in by_f.values()
            for q in qs]
    if model == "mpqe":
        jcfg = jm.MPQEConfig(**{k: mc[k] for k in (
            "n_entities", "n_modes", "n_rels", "embed_dim", "n_layers",
            "num_bases", "readout", "margin")})
        params = convert.model_to_numpy(tmodel)
    else:
        jcfg = jgqe.GQEConfig(**{k: mc[k] for k in (
            "n_entities", "n_modes", "n_rels", "embed_dim", "decoder",
            "intersection", "soft_and", "margin")})
        params = convert.gqe_to_numpy(tmodel)
    server = JaxServer(jax.tree.map(jax.numpy.asarray, params), jcfg,
                       jkg.entity_mode)
    with jax.default_matmul_precision("highest"):
        want = server.answer(flat, k=10)
    np.testing.assert_array_equal(got["entity_ids"],
                                  np.stack([a.entity_ids for a in want]))
    np.testing.assert_allclose(got["scores"],
                               np.stack([a.scores for a in want]),
                               rtol=0, atol=1e-5)
    assert list(got["structure"]) == [q.formula.structure for q in flat]
    np.testing.assert_array_equal(got["target"], [q.target for q in flat])
    assert got["target"].dtype == np.int32
    assert (line["queries"], line["k"], line["out"]) == (len(flat), 10, out)
    assert line["checkpoint"].endswith("step_3")
    hits = np.mean([q.target in a.entity_ids.tolist()
                    for q, a in zip(flat, want)])
    assert line["hit_at_k"] == pytest.approx(hits)
    assert line["queries_per_s"] > 0


def test_serve_answer_needs_out(pkl_run):
    run, _ = pkl_run
    with pytest.raises(SystemExit, match=r"--answer requires --out "
                                         r"<file.npz>"):
        tserve.main(["--run_dir", run, "--device", "cpu", "--answer",
                     "q.pkl"])


# ------------------------------------------------------- quality_bench
QB = ["--entities", "150", "--train_per_structure", "10",
      "--val_per_structure", "5"]


@pytest.mark.parametrize("extra", [[], ["--holdout", "3-inter,2-chain",
                                        "--seed", "2"],
                                   ["--kg_variant", "warp", "--kg_noise",
                                    "0.05"]])
def test_quality_bench_build_data_matches(extra):
    jqb = _jax_tool("quality_bench")
    args = tqb.parse_args(QB + extra)
    tkg, ttr, tva = tqb.build_data(args)
    jkg, jtr, jva = jqb.build_data(argparse.Namespace(**vars(args)))
    assert_kgs_equal(tkg, jkg)
    assert grouped_keys(ttr) == grouped_keys(jtr)
    assert grouped_keys(tva) == grouped_keys(jva)


def test_quality_bench_runs_and_writes_the_summary(tmp_path):
    out = str(tmp_path / "q")
    with contextlib.redirect_stdout(io.StringIO()) as buf, \
            contextlib.redirect_stderr(io.StringIO()):
        results = tqb.main(QB + ["--device", "cpu", "--steps", "20",
                                 "--dim", "16", "--bases", "4",
                                 "--batch_size", "32", "--out", out])
    lines = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    assert [ln["model"] for ln in lines] == ["mpqe", "gqe"]
    for ln, (name, res) in zip(lines, results.items()):
        assert ln == json.loads(json.dumps({"model": name, **res.flat()}))
        assert 0.0 <= ln["auc_macro"] <= 1.0
    summary = open(os.path.join(out, "summary.md")).read()
    assert summary.startswith("# Quality benchmark: MPQE-TGT vs GQE-bilinear")
    assert "| **macro** |" in summary and "20 steps each" in summary


def test_quality_bench_needs_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqb.main(QB + ["--out", str(tmp_path / "q")])


def test_quality_bench_gqe_arm_evaluates_as_the_reference():
    # the GQE arm's per-formula evaluation (evaluate with the GQE
    # encode_fn) on the same parameters and queries: AUC and APR within
    # 1e-4 (f32 both sides, another sum order), as the MPQE per-formula
    # evaluation is held in tests/test_torch_port_eval.py
    from mpqe_tpu.train import evaluation as jeval
    from mpqe_tpu_torch.models import gqe as tgqe
    from mpqe_tpu_torch.train import evaluation as teval

    args = tqb.parse_args(QB)
    tkg, _, tva = tqb.build_data(args)
    jkg, _, jva = _jax_tool("quality_bench").build_data(
        argparse.Namespace(**vars(args)))
    kw = dict(n_entities=tkg.n_entities, n_modes=tkg.n_modes,
              n_rels=tkg.n_rels, embed_dim=16)
    jcfg, tcfg = jgqe.GQEConfig(**kw), tgqe.GQEConfig(**kw)
    params = jgqe.init_gqe(jax.random.PRNGKey(0), jcfg)
    model = convert.gqe_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")
    with jax.default_matmul_precision("highest"):
        want = jeval.evaluate(params, jcfg, jva, n_neg=64,
                              encode_fn=jax.jit(jgqe.encode_dense,
                                                static_argnums=(1, 2)))
    got = teval.evaluate(model, tcfg, tva, n_neg=64,
                         encode_fn=tgqe.encode_dense)
    a, b = got.flat(), want.flat()
    assert set(a) == set(b)
    for key in a:
        tol = 1e-2 if key.startswith("apr") else 1e-4  # APR is in percent
        assert abs(a[key] - b[key]) <= tol, (key, a[key], b[key])
