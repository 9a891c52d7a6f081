"""The ported benchmark tools (``mpqe_tpu_torch/tools``: ``serve_bench``,
``eval_bench``, ``e2e_train_bench``, ``step_breakdown``,
``loss_breakdown``, ``bf16_shared_bench``, ``big_kg_demo``) against the
reference tools and the JAX package, on the CPU at small sizes.

* Functions held to the reference tool on the same numpy inputs (the
  reference imported by path): ``random_queries`` and
  ``make_flagship_store`` equal, array for array; the batch draw equal to
  the reference's order.
* Phases against JAX written out here, parameters carried across with
  ``convert.py``: ``loss_breakdown``'s five phases and ``step_breakdown``'s
  loss (f32, within 1e-5), ``bf16_shared_bench``'s four base combos (f32
  within 1e-5; bf16 within ``test_torch_port_bf16.py``'s TOL_LOSS).
* Each ``main`` at a tiny size under ``--device cpu``, its module
  constants shrunk with ``monkeypatch``: exit 0 and the records
  ``chip_smoke.py`` holds the tool to (the reference's keys); without a
  card and without ``--device cpu`` it raises.
* No tool imports JAX or the JAX package.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import embed as jembed
from mpqe_tpu.queries import STRUCTURES
from mpqe_tpu_torch import convert
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.tools import probe_common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_TOOLS = ("serve_bench", "eval_bench", "e2e_train_bench",
               "step_breakdown", "loss_breakdown", "bf16_shared_bench",
               "big_kg_demo")
PROBE_TOOLS = ("embed_scatter_exp", "gather_exp", "fused_fwd_bench",
               "fwd_gemm_floor", "kernel_bench", "scaling_bench",
               "fused_bwd_diag", "kernel_smoke", "mlp_readout_diag",
               "probe_pickles")
TOL_F32 = 1e-5
TOL_BF16_LOSS = 3e-3  # test_torch_port_bf16.py's TOL_LOSS
N_ENT, N_RELS, D, B = 60, 9, 16, 24

# tiny sizes for each tool's main: (extra argv, module constants)
SMALL = {
    "serve_bench": (["--entities", "3000", "--dim", "16", "--bases", "4",
                     "--batch", "8", "--http_batch", "4"], {}),
    "eval_bench": ([], dict(N_ENTITIES=500, D=16, NUM_BASES=4)),
    "e2e_train_bench": (["--entities", "400", "--dim", "16", "--bases", "4",
                         "--batch_size", "32", "--store_queries", "100"], {}),
    # 655,360 touched rows need a table at least that long (D = 4)
    "step_breakdown": ([], dict(N_ENTITIES=700_000, D=4, B=16)),
    "loss_breakdown": ([], dict(N_ENTITIES=500, D=16, B=32)),
    "bf16_shared_bench": ([], dict(N_ENTITIES=500, D=16, NUM_BASES=4, B=32,
                                   K_SHARED=8)),
    "big_kg_demo": (["--entities", "2000", "--triples", "20000",
                     "--queries", "500", "--batch_size", "64"], {}),
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


def run_main(name, argv, capsys):
    rc = _tool(name).main(argv)
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    return rc, records


# ------------------------------------------------ functions = reference
def test_random_queries_equal_the_reference():
    ref = _ref_tool("serve_bench")
    args = (["1-chain", "2-inter", "3-chain_inter"], 7, 1000, 4, 266)
    want = ref.random_queries(*args, seed=3)
    got = _tool("serve_bench").random_queries(*args, seed=3)
    assert list(got) == list(want)
    for s in want:
        assert [(q.formula.structure, q.formula.rels, q.formula.node_modes,
                 q.anchors, q.target) for q in got[s]] == [
            (q.formula.structure, q.formula.rels, q.formula.node_modes,
             q.anchors, q.target) for q in want[s]]


def test_flagship_store_equals_the_reference():
    ref = _ref_tool("e2e_train_bench")
    args = (4000, 4, 266, 500, "3-chain_inter")
    want = ref.make_flagship_store(*args, seed=5)
    got = _tool("e2e_train_bench").make_flagship_store(*args, seed=5)
    assert (got.formula.structure, got.formula.rels,
            got.formula.node_modes) == (want.formula.structure,
                                        want.formula.rels,
                                        want.formula.node_modes)
    for f in ("anchors", "targets", "neg_pool", "neg_ptr", "hard_pool",
              "hard_ptr", "fallback_pool"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _ref_batch(n_ent, n_modes, n_rels, structure, b, n_neg):
    """The reference breakdowns' draw, written out."""
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(0)
    return (rng.integers(0, n_ent, (b, spec.n_nodes)).astype(np.int32),
            rng.integers(0, n_modes, (b, spec.n_nodes)).astype(np.int32),
            rng.integers(0, n_rels, (spec.n_edges,)).astype(np.int32),
            np.ones((spec.n_edges,), np.float32),
            rng.integers(0, n_ent, (b,)).astype(np.int32),
            rng.integers(0, n_ent, (b, n_neg)).astype(np.int32),
            np.ones((b, n_neg), np.float32), np.ones((b,), np.float32))


def test_dense_batch_is_the_references_draw():
    got = probe_common.dense_batch(N_ENT, 4, N_RELS, "3-chain_inter", B, 4,
                                   torch.device("cpu"))
    for a, b in zip(got, _ref_batch(N_ENT, 4, N_RELS, "3-chain_inter", B, 4)):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------ phases = JAX
def _models(dtype="float32", nb=4, seed=0):
    kw = dict(n_entities=N_ENT, n_modes=4, n_rels=N_RELS, embed_dim=D,
              n_layers=3, num_bases=nb, readout="tgt")
    jcfg = jm.MPQEConfig(**kw, dtype=getattr(jnp, dtype))
    tcfg = tm.MPQEConfig(**kw, dtype=getattr(torch, dtype))
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    for lp in params["layers"]:
        lp["bias"] = jnp.asarray(0.1 * rng.normal(size=lp["bias"].shape),
                                 jcfg.dtype)
    model = convert.model_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     "cpu")
    return jcfg, tcfg, params, model


def _f(x):
    """A torch or JAX array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _rel(got, want):
    got, want = _f(got), _f(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_loss_breakdown_phases_match_jax(monkeypatch):
    tool = _tool("loss_breakdown")
    s = tool.STRUCTURE
    jcfg, tcfg, params, model = _models()
    arrays = _ref_batch(N_ENT, 4, N_RELS, s, B, 4)
    ne, nm, er, en, tgt, neg, nmask, qmask = arrays
    t = [torch.from_numpy(a) for a in arrays]
    got = {k: fn(t[3]) for k, fn in tool.phases(
        model, tcfg, t[0], t[1], t[2], t[4], t[5], t[6], t[7]).items()}
    a_slots = list(jm.anchor_gather_slots(jcfg, s))
    idx_all = jnp.concatenate([ne[:, a_slots], tgt[:, None], neg], axis=1)
    with jax.default_matmul_precision("highest"):
        enc = jm.encode_dense(params, jcfg, s, ne, nm, er, en)
        gat = jembed.embedding_lookup(params["emb"]["ent"], idx_all)
        pos = jm.score(jcfg, enc, params["emb"]["ent"][tgt])
        want = {
            "encode": jnp.sum(enc) * 1e-9,
            "gather": jnp.sum(gat) * 1e-9,
            "enc_gather": (jnp.sum(enc) + jnp.sum(gat)) * 1e-9,
            "pos_score": jnp.sum(pos) * 1e-9,
            "full_loss": jm.dense_batch_loss(params, jcfg, s, ne, nm, er, en,
                                             tgt, neg, nmask, qmask),
        }
    # the sums cancel: each is held against the sum of its terms' sizes
    sizes = {"encode": jnp.sum(jnp.abs(enc)) * 1e-9,
             "gather": jnp.sum(jnp.abs(gat)) * 1e-9,
             "enc_gather": (jnp.sum(jnp.abs(enc)) + jnp.sum(jnp.abs(gat)))
             * 1e-9,
             "pos_score": jnp.sum(jnp.abs(pos)) * 1e-9,
             "full_loss": want["full_loss"]}
    assert list(got) == list(want)
    for k in want:
        err = abs(_f(got[k]) - _f(want[k])) / _f(sizes[k])
        assert err <= TOL_F32, (k, err)


@pytest.mark.parametrize("kernel", ["dense", "fused_fwd"])
def test_step_breakdown_loss_matches_jax(kernel):
    tool = _tool("step_breakdown")
    s = tool.STRUCTURE
    jcfg, tcfg, params, model = _models()
    arrays = _ref_batch(N_ENT, 4, N_RELS, s, B, 4)
    t = [torch.from_numpy(a) for a in arrays]
    got = tool.loss_for(kernel, tcfg, t[0], t[1], t[2], *t[4:])(model, t[3])
    ne, nm, er, en, tgt, neg, nmask, qmask = arrays
    with jax.default_matmul_precision("highest"):
        if kernel == "fused_fwd":
            want = jm.dense_batch_loss_kernel_fused_fwd(
                params, jcfg, s, ne, nm, er, en, tgt, neg, nmask, qmask,
                interpret=True, backward="pallas")
        else:
            want = jm.dense_batch_loss(params, jcfg, s, ne, nm, er, en, tgt,
                                       neg, nmask, qmask)
    assert _rel(got, want) <= TOL_F32


def _jax_combo_loss(params, jcfg, tool, shared):
    """``bf16_shared_bench``'s loss written out in JAX, its inputs drawn
    in the reference's order."""
    s = tool.STRUCTURE
    spec = STRUCTURES[s]
    rng = np.random.default_rng(0)
    ne = rng.integers(0, tool.N_ENTITIES, (tool.B, spec.n_nodes)
                      ).astype(np.int32)
    nm = rng.integers(0, tool.N_MODES, (tool.B, spec.n_nodes)
                      ).astype(np.int32)
    er = rng.integers(0, tool.N_RELS, (spec.n_edges,)).astype(np.int32)
    en = np.ones((spec.n_edges,), np.float32)
    tgt = rng.integers(0, tool.N_ENTITIES, (tool.B,)).astype(np.int32)
    qmask = np.ones((tool.B,), np.float32)
    if shared:
        sneg = rng.integers(0, tool.N_ENTITIES, (tool.K_SHARED,)
                            ).astype(np.int32)
        return jm.dense_batch_loss_shared_negs(params, jcfg, s, ne, nm, er,
                                               en, tgt, sneg, qmask)
    neg = rng.integers(0, tool.N_ENTITIES, (tool.B, tool.N_NEG)
                       ).astype(np.int32)
    nmask = np.ones((tool.B, tool.N_NEG), np.float32)
    return jm.dense_batch_loss(params, jcfg, s, ne, nm, er, en, tgt, neg,
                               nmask, qmask)


@pytest.mark.parametrize("combo", ["f32", "bf16", "f32_shared",
                                   "bf16_shared"])
def test_bf16_shared_base_combos_match_jax(combo, monkeypatch):
    tool = _tool("bf16_shared_bench")
    for k, v in dict(N_ENTITIES=N_ENT, N_RELS=N_RELS, D=D, NUM_BASES=4,
                     B=B, K_SHARED=7).items():
        monkeypatch.setattr(tool, k, v)
    dtype, shared, fused = tool.KNOWN_COMBOS[combo]
    assert not fused
    jcfg, tcfg, params, model = _models(dtype)
    got = tool.loss_fn_for(model, tcfg, torch.device("cpu"), shared,
                           fused)(model)
    with jax.default_matmul_precision("highest"):
        want = _jax_combo_loss(params, jcfg, tool, shared)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16_LOSS
    assert _rel(got, want) <= tol, _rel(got, want)


# ------------------------------------------------ each main
def _expected(name):
    return [(argv, exp) for n, argv, exp in chip_smoke.TOOL_RUNS
            if n == name]


@pytest.mark.parametrize("name,case", [
    (n, i) for n in BENCH_TOOLS for i in range(len(_expected(n)))])
def test_main_prints_the_reference_records(name, case, monkeypatch, capsys,
                                           short_loops):
    argv, expected = _expected(name)[case]
    extra, consts = SMALL[name]
    for k, v in consts.items():
        monkeypatch.setattr(_tool(name), k, v)
    rc, records = run_main(name, argv + extra + ["--device", "cpu"], capsys)
    assert rc == 0
    assert chip_smoke.tool_record_faults(records, expected) == []
    # a CPU run measures no device time
    assert all(r.get("device_ms") is None for r in records)


def test_record_check_catches_a_missing_key_and_a_bad_time():
    expected = [({"phase": "stream"}, ["latency_ms_p50", "queries_per_s"])]
    good = [{"phase": "stream", "latency_ms_p50": 1.5, "queries_per_s": 9.0}]
    assert chip_smoke.tool_record_faults(good, expected) == []
    assert chip_smoke.tool_record_faults(
        [{"phase": "stream", "latency_ms_p50": 1.5}], expected)
    assert chip_smoke.tool_record_faults(
        [dict(good[0], queries_per_s=float("nan"))], expected)
    assert chip_smoke.tool_record_faults(
        [dict(good[0], errors=2)], expected)
    assert chip_smoke.tool_record_faults(good + [{"phase": "x"}], expected)


@pytest.mark.parametrize("name", BENCH_TOOLS)
def test_main_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool(name).main([])


def test_tools_import_no_jax():
    code = ("import sys, importlib\n"
            f"for n in {BENCH_TOOLS + PROBE_TOOLS!r}:\n"
            "    importlib.import_module('mpqe_tpu_torch.tools.' + n)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'mpqe_tpu', 'ml_dtypes'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
