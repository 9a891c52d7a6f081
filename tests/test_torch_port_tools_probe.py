"""The ported probes and diagnostics (``mpqe_tpu_torch/tools``:
``embed_scatter_exp``, ``gather_exp``, ``fused_fwd_bench``,
``fwd_gemm_floor``, ``kernel_bench``, ``scaling_bench``,
``fused_bwd_diag``, ``kernel_smoke``, ``mlp_readout_diag``,
``probe_pickles``) against the reference tools and the JAX package, on
the CPU at small sizes.

* Functions held to the reference tool on the same numpy inputs (the
  reference imported by path): the three scatters within 1e-6, duplicate
  ids included; ``walk`` equal; ``probe_pickles``' check lines equal on
  pickles written by the port's ``prepare_dataset``, and on a malformed
  file; ``mlp_readout_diag.build_data`` equal.
* Against JAX written out here: ``mlp_readout_diag``'s arm inits
  (``mlp_id``'s near-identity matrices, ``mlp_he``'s scale) and its mean
  pooling, f32 within 1e-5.
* Each ``main`` at a tiny size under ``--device cpu`` (module constants
  shrunk with ``monkeypatch``): exit 0 and the records ``chip_smoke.py``
  holds the tool to; ``kernel_smoke`` exits 0, and 1 when a plain kernel
  is made wrong; ``kernel_bench`` exits 1 when its routes disagree;
  without a card and without ``--device cpu`` each raises.
"""

import argparse
import importlib
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.tools import probe_common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_TOOLS = ("embed_scatter_exp", "gather_exp", "fused_fwd_bench",
               "fwd_gemm_floor", "kernel_bench", "scaling_bench",
               "fused_bwd_diag", "kernel_smoke", "mlp_readout_diag")
TOL = 1e-6  # the scatters: the same f32 adds in another order
TOL_F32 = 1e-5

SMALL = {
    "embed_scatter_exp": ([], dict(N=300, D=8, B=64)),
    "gather_exp": ([], dict(N=300, M=1000)),
    "fused_fwd_bench": (["--batch", "32"], dict(N_ENTITIES=500, D=16,
                                               NUM_BASES=4)),
    "fwd_gemm_floor": ([], dict(B=64)),
    "kernel_bench": (["--n_nodes", "256", "--n_edges", "2000", "--n_rels",
                      "8", "--d", "16", "--num_bases", "4", "--chunk", "64"],
                     {}),
    "scaling_bench": (["--nodes", "256", "--edges", "2000", "--n_rels", "8",
                       "--d", "16", "--num_bases", "4", "--rank_entities",
                       "1000", "--rank_batch", "16"], {}),
    "fused_bwd_diag": (["--batch", "64"], {}),
    "kernel_smoke": ([], dict(BQ=64, SDDMM_EDGES=256)),
    "mlp_readout_diag": (["--entities", "120", "--train_per_structure",
                          "20", "--val_per_structure", "5", "--batch_size",
                          "16", "--n_neg", "4", "--dim", "16", "--bases",
                          "4", "--steps", "8"], {}),
}


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool(name):
    return importlib.import_module(f"mpqe_tpu_torch.tools.{name}")


@pytest.fixture
def short_loops(monkeypatch):
    monkeypatch.setattr(probe_common, "LOOP", dict(
        n_small=1, n_large=2, samples=1, profile=None))


def _shrink(monkeypatch, name):
    for k, v in SMALL[name][1].items():
        monkeypatch.setattr(_tool(name), k, v)


# ------------------------------------------------ functions = reference
@pytest.mark.parametrize("kind", ["plain", "sorted", "dedup"])
def test_scatters_match_the_reference(kind):
    ref = _ref_tool("embed_scatter_exp")
    rng = np.random.default_rng(4)
    n, m, d = 50, 400, 8
    idx = rng.integers(0, n, m).astype(np.int32)
    idx[::7] = idx[0]  # one id many times
    g = rng.normal(size=(m, d)).astype(np.float32)
    want = np.asarray(getattr(ref, f"scatter_{kind}")(
        n, jnp.asarray(idx), jnp.asarray(g)))
    got = getattr(_tool("embed_scatter_exp"), f"scatter_{kind}")(
        n, torch.from_numpy(idx), torch.from_numpy(g)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_scatter_variants_give_one_gradient():
    tool = _tool("embed_scatter_exp")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (30, 7)).astype(np.int32))
    c = torch.from_numpy(rng.normal(size=(30, 7, 8)).astype(np.float32))
    grads = [tool.grad_of(tool.make_loss(v), table, idx, c)
             for v in tool.VARIANTS]
    for g in grads[1:]:
        assert float((g - grads[0]).abs().mean()
                     / grads[0].abs().mean()) <= TOL


def test_walk_equals_the_reference():
    ref = _ref_tool("fused_bwd_diag")
    rng = np.random.default_rng(1)
    a = {"b": [rng.normal(size=(3, 4)), rng.normal(size=5)],
         "a": {"x": rng.normal(size=(2,)), "e": np.zeros((0,))},
         "c": (rng.normal(size=(4,)),)}
    b = jax.tree.map(lambda v: v + 1e-3 * np.sign(v), a)
    want = ref.walk(a, b, "root")
    got = _tool("fused_bwd_diag").walk(
        jax.tree.map(torch.from_numpy, a), b, "root")
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[1:] for r in got], [r[1:] for r in want],
                               rtol=1e-6)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """A dataset directory written by the port's ``prepare_dataset``, and
    a malformed graph pickle beside it."""
    from mpqe_tpu_torch.data import loader
    from mpqe_tpu_torch.data.sampler import make_rule_kg

    d = tmp_path_factory.mktemp("probe")
    kg = make_rule_kg(n_entities=300, n_modes=3, n_base_rels=6,
                      out_degree=2, seed=0)
    loader.save_kg_npz(str(d / "rule.npz"), kg)
    subprocess.run(
        [sys.executable, "-m", "mpqe_tpu_torch.tools.prepare_dataset",
         "--npz", str(d / "rule.npz"), "--out", str(d / "rule"),
         "--train_per_structure", "10", "--eval_per_structure", "3",
         "--n_neg", "4"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        check=True, capture_output=True, timeout=300)
    with open(d / "bad_graph.pkl", "wb") as f:
        pickle.dump({"not": "a tuple"}, f)
    return d


@pytest.mark.parametrize("fname", ["rule/graph_data.pkl",
                                   "rule/train_queries_2.pkl",
                                   "rule/test_queries_3.pkl",
                                   "bad_graph.pkl"])
def test_probe_pickles_prints_the_reference_checks(fname, prepared, capsys,
                                                   monkeypatch):
    path = str(prepared / fname)
    kind = ["--kind", "graph"] if "graph" in fname else []
    monkeypatch.setattr(sys, "argv", ["probe_pickles.py", path, *kind])
    _ref_tool("probe_pickles").main()
    want = capsys.readouterr().out.splitlines()
    assert _tool("probe_pickles").main([path, *kind, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()

    def checks(lines):
        return [ln for ln in lines if ln.startswith(("[", "    field"))]

    assert checks(got) == checks(want) and checks(want)
    assert got[:got.index("== structure ==") + 1] == \
        want[:want.index("== structure ==") + 1]
    if fname == "bad_graph.pkl":
        assert checks(got) == [
            "[FAIL] top level is a 3-tuple — got dict len=1 -> adjust "
            "load_graph_pickle unpacking"]
    else:
        assert all(ln.startswith("[OK ") for ln in checks(got)
                   if ln.startswith("["))


def _diag_args(**kw):
    base = dict(entities=120, train_per_structure=20, val_per_structure=5,
                steps=8, batch_size=16, n_neg=4, dim=16, bases=4, lr=0.01,
                seed=0)
    return argparse.Namespace(**{**base, **kw})


def test_mlp_readout_data_equals_the_reference():
    ref = _ref_tool("mlp_readout_diag")
    jkg, jtrain, jval = ref.build_data(_diag_args())
    tkg, ttrain, tval = _tool("mlp_readout_diag").build_data(_diag_args())
    for f in ("heads", "rels", "tails", "entity_mode"):
        np.testing.assert_array_equal(getattr(tkg, f), getattr(jkg, f))

    def flat(by_structure):
        return sorted((q.formula.structure, q.formula.rels,
                       q.formula.node_modes, q.anchors, q.target,
                       tuple(q.neg_samples), tuple(q.hard_neg_samples))
                      for by_f in by_structure.values()
                      for qs in by_f.values() for q in qs)

    assert flat(ttrain) == flat(jtrain)
    assert flat(tval) == flat(jval)


def _mlp_model(seed=0, d=16):
    cfg = tm.MPQEConfig(n_entities=30, n_modes=3, n_rels=6, embed_dim=d,
                        n_layers=3, num_bases=4, readout="mlp")
    return tm.init_mpqe(torch.Generator().manual_seed(seed), cfg)


def test_mlp_id_init_matches_jax():
    model = _mlp_model()
    ro = model.readout
    w_post0 = jnp.asarray(ro.w_post.detach().numpy().copy())
    w_pre0 = jnp.asarray(ro.w_pre.detach().numpy().copy())
    _tool("mlp_readout_diag").init_arm("mlp_id", model, 0)
    d = w_post0.shape[0]
    for got, w0 in ((ro.w_post, w_post0), (ro.w_pre, w_pre0)):
        want = np.asarray(jnp.eye(d, dtype=w0.dtype) + 0.05 * w0)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=TOL_F32)


def test_mlp_he_init_has_the_he_scale():
    d = 64
    model = _mlp_model(d=d)
    w_post0 = model.readout.w_post.detach().clone()
    _tool("mlp_readout_diag").init_arm("mlp_he", model, 0)
    w = model.readout.w_pre.detach().numpy()
    # 4,096 draws of N(0, 2/d): the sample std within 5 % of sqrt(2/d)
    assert abs(w.std() / np.sqrt(2.0 / d) - 1) < 0.05
    assert abs(w.mean()) < 0.05 * np.sqrt(2.0 / d) * 3
    assert torch.equal(model.readout.w_post, w_post0)


def test_mlp_mean_pooling_matches_jax():
    from mpqe_tpu_torch.models import readout as readout_mod

    model = _mlp_model()
    ro = model.readout
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 4, 16)).astype(np.float32)
    got = _tool("mlp_readout_diag").mean_pool_readout(
        readout_mod.readout_dense)("mlp", ro, torch.from_numpy(x), 0)
    p = {k: jnp.asarray(getattr(ro, k).detach().numpy())
         for k in ("w_pre", "b_pre", "w_post", "b_post")}
    with jax.default_matmul_precision("highest"):
        h = jax.nn.relu(jnp.einsum("bnd,do->bno", x, p["w_pre"])
                        + p["b_pre"])
        want = jnp.dot(jnp.mean(h, axis=1), p["w_post"]) + p["b_post"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL_F32, atol=TOL_F32)
    # the other readouts are the original's
    assert torch.equal(
        _tool("mlp_readout_diag").mean_pool_readout(
            readout_mod.readout_dense)("sum", ro, torch.from_numpy(x), 0),
        torch.from_numpy(x).sum(1))


# ------------------------------------------------ each main
def _expected(name):
    return [(argv, exp) for n, argv, exp in chip_smoke.TOOL_RUNS
            if n == name]


@pytest.mark.parametrize("name,case", [
    (n, i) for n in PROBE_TOOLS for i in range(len(_expected(n)))])
def test_main_prints_the_reference_records(name, case, monkeypatch, capsys,
                                           short_loops):
    argv, expected = _expected(name)[case]
    _shrink(monkeypatch, name)
    rc = _tool(name).main(argv + SMALL[name][0] + ["--device", "cpu"])
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert rc == 0
    assert chip_smoke.tool_record_faults(records, expected) == []
    assert all(r.get("device_ms") is None for r in records)


@pytest.mark.parametrize("wrong", ["segment_kernels.segment_sum_reference",
                                   "sddmm.sddmm_reference"])
def test_kernel_smoke_fails_on_a_wrong_plain_kernel(wrong, monkeypatch,
                                                    capsys):
    _shrink(monkeypatch, "kernel_smoke")
    mod_name, fn_name = wrong.split(".")
    mod = importlib.import_module(f"mpqe_tpu_torch.ops.{mod_name}")
    right = getattr(mod, fn_name)
    monkeypatch.setattr(mod, fn_name, lambda *a, **k: right(*a, **k) * 1.01)
    assert _tool("kernel_smoke").main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH" in out and '"ok": false' in out


def test_kernel_bench_fails_when_its_routes_disagree(monkeypatch, capsys,
                                                     short_loops):
    from mpqe_tpu_torch.ops import rgcn_fused as rf

    right = rf.rgcn_sparse_fused
    monkeypatch.setattr(rf, "rgcn_sparse_fused",
                        lambda *a, **k: right(*a, **k) * (1 + 1e-3))
    argv = SMALL["kernel_bench"][0] + ["--paths", "xla,fused",
                                       "--device", "cpu"]
    assert _tool("kernel_bench").main(argv) == 1
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"agree"')]
    assert [r["ok"] for r in recs] == [False]


@pytest.mark.parametrize("name", PROBE_TOOLS + ("probe_pickles",))
def test_main_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["unused.pkl"] if name == "probe_pickles" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool(name).main(argv)
