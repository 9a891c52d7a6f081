"""The quantized candidate tables of the PyTorch port
(``mpqe_tpu_torch/parallel/rank_shard.py``, ``QueryServer(table_dtype=)``)
against the JAX package's ``mpqe_tpu/parallel/rank_shard.py`` and
``QueryServer``.

Tolerances:
* int8 ``quantized_scores``: bit-equal.  ``round(clip(q, -1, 1) * 127)``
  rounds half to even on both sides and the int32 sums are exact
  (``127² · d`` is far inside int32), so only the one f32 rescale is
  left, the same on both.
* bfloat16 ``quantized_scores``: 1e-6 absolute.  The products of the
  bf16 operands are exact in f32; only the f32 sum order differs
  (measured 6.0e-8 on scores of magnitude <= 1).
* float32: 1e-6 absolute, the same reason (measured 6.0e-8).
* ``quantize_rows`` / ``quantize_table``: bit-equal.
* served answers against the JAX server, both encoders through K3 (the
  JAX one in interpret mode): ids equal, scores within 1e-4 (the K3
  servers' own bound, ``tests/test_torch_port_serve.py``).
* the recall rule of the reference (``tests/test_serve.py:183-201``): on
  a trained model, each quantized table's mean top-10 overlap with the
  float32 table's >= 0.8 and its scores within 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpqe_tpu.models.mpqe as jm
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.models import gqe as jgqe
from mpqe_tpu.ops import pallas_fused_fwd as jff
from mpqe_tpu.parallel import rank_shard as jrs
from mpqe_tpu.queries import STRUCTURE_NAMES
from mpqe_tpu.serve import QueryServer as JaxServer
from mpqe_tpu_torch import convert
from mpqe_tpu_torch import queries as tq
from mpqe_tpu_torch import serve as tserve
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.models import gqe as tgqe
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.parallel import rank_shard as trs

QUANT = ("bfloat16", "int8")
KG = dict(n_entities=300, n_modes=4, n_base_rels=6, n_triples=2000, seed=0)
K = 10


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------- the formulas
@pytest.mark.parametrize("B", [1, 16, 37, 256])
def test_int8_scores_bit_equal_to_jax(B):
    rng = np.random.default_rng(B)
    table = _unit_rows(rng, 500, 32)
    q = _unit_rows(rng, B, 32)
    # exact half steps (k / 254: q * 127 = k / 2) and values past +-1
    q[0, :8] = np.arange(-4, 4) / 254.0 * 3
    q[-1, :4] = [1.5, -1.5, 0.5 / 127, -2.5 / 127]
    jt = jrs.quantize_rows(jnp.asarray(table), "int8").T
    tt = trs.quantize_rows(torch.from_numpy(table), "int8").t()
    np.testing.assert_array_equal(tt.t().numpy(), np.asarray(jt.T))
    want = np.asarray(jrs.quantized_scores(jnp.asarray(q), jt, "int8"))
    got = trs.quantized_scores(torch.from_numpy(q), tt, "int8")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("table_dtype", ["bfloat16", "float32"])
def test_bf16_and_f32_scores_match_jax(table_dtype):
    rng = np.random.default_rng(5)
    table = _unit_rows(rng, 700, 48)
    q = _unit_rows(rng, 33, 48)
    jt = jrs.quantize_rows(jnp.asarray(table), table_dtype).T
    tt = trs.quantize_rows(torch.from_numpy(table), table_dtype).t()
    np.testing.assert_array_equal(
        tt.t().float().numpy(), _jnp(jt.T))
    want = np.asarray(jrs.quantized_scores(jnp.asarray(q), jt, table_dtype))
    got = trs.quantized_scores(torch.from_numpy(q), tt, table_dtype)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("scale", [True, False])
def test_quantize_table_matches_jax(table_dtype, scale):
    rng = np.random.default_rng(2)
    ent = rng.normal(size=(64, 16)).astype(np.float32)
    if table_dtype == "int8" and not scale:
        with pytest.raises(ValueError, match="cosine scoring"):
            jrs.quantize_table(jnp.asarray(ent), table_dtype, scale)
        with pytest.raises(ValueError, match="cosine scoring"):
            trs.quantize_table(torch.from_numpy(ent), table_dtype, scale)
        return
    want = jrs.quantize_table(jnp.asarray(ent), table_dtype, scale)
    got = trs.quantize_table(torch.from_numpy(ent), table_dtype, scale)
    assert str(got.dtype).endswith(str(want.dtype))
    np.testing.assert_array_equal(got.float().numpy(), _jnp(want))


def test_unknown_table_dtype_raises():
    x = torch.zeros((2, 4))
    for fn in (lambda: trs.quantize_rows(x, "fp8"),
               lambda: trs.quantized_scores(x, x.t(), "fp8"),
               lambda: trs.check_table_dtype("float16")):
        with pytest.raises(ValueError, match="unknown table_dtype"):
            fn()


# ------------------------------------------------------------ serving
def _mpqe(dtype, seed=0):
    kw = dict(n_entities=300, n_modes=4, n_rels=12, embed_dim=16,
              n_layers=3, num_bases=4)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jcfg = jm.MPQEConfig(**kw, dtype=jdt)
    tcfg = tm.MPQEConfig(**kw, dtype=dtype)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        lp["bias"] = jnp.asarray(0.1 * rng.normal(size=lp["bias"].shape),
                                 jdt)
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
    return a, b, tqs.kg.entity_mode


def _answers(server, queries, k=K):
    out = server.answer(queries, k=k)
    return (np.stack([a.entity_ids for a in out]),
            np.stack([a.scores for a in out]))


@pytest.fixture
def interpret_k3(monkeypatch):
    """Route the JAX servers' encoder through the Pallas K3 kernel in
    interpret mode (it otherwise takes the f32 path on the CPU)."""
    def auto(params, cfg, structure, ne, nm, er, en):
        return jff.fused_tgt_forward_multi(params, cfg, structure, ne, nm,
                                           er, en, block=8, interpret=True)

    monkeypatch.setattr(jm, "encode_dense_multi_auto", auto)


@pytest.mark.parametrize("model_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table_dtype", QUANT)
def test_quantized_server_matches_jax(table_dtype, model_dtype,
                                      interpret_k3):
    dtype = getattr(torch, model_dtype)
    jcfg, tcfg, params, model = _mpqe(dtype)
    jqs, tqs, mode = _queries()
    with jax.default_matmul_precision("highest"):
        j_ids, j_sc = _answers(JaxServer(params, jcfg, mode,
                                         table_dtype=table_dtype), jqs)
    server = tserve.QueryServer(model, tcfg, mode, device="cpu",
                                table_dtype=table_dtype)
    assert server._ent_norm_t.dtype == getattr(torch, table_dtype)
    t_ids, t_sc = _answers(server, tqs)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-4)


@pytest.mark.parametrize("table_dtype", QUANT)
def test_quantized_gqe_server_matches_jax(table_dtype):
    kw = dict(n_entities=300, n_modes=4, n_rels=12, embed_dim=16,
              decoder="bilinear", intersection="mean", soft_and=True)
    jcfg, tcfg = jgqe.GQEConfig(**kw), tgqe.GQEConfig(**kw)
    params = jgqe.init_gqe(jax.random.PRNGKey(4), jcfg)
    model = convert.gqe_from_numpy(jax.tree.map(np.asarray, params), tcfg)
    jqs, tqs, mode = _queries(n_per=3, seed=9)
    with jax.default_matmul_precision("highest"):
        j_ids, j_sc = _answers(JaxServer(params, jcfg, mode,
                                         table_dtype=table_dtype), jqs)
    t_ids, t_sc = _answers(tserve.QueryServer(
        model, tcfg, mode, device="cpu", table_dtype=table_dtype), tqs)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-4)


def test_server_refusals_match_the_reference():
    _, tcfg, _, model = _mpqe(torch.float32)
    mode = np.zeros(300, np.int32)
    with pytest.raises(ValueError, match="unknown table_dtype"):
        tserve.QueryServer(model, tcfg, mode, device="cpu",
                           table_dtype="fp8")
    with pytest.raises(ValueError, match="needs cosine scoring"):
        tserve.QueryServer(model, dataclasses.replace(
            tcfg, scale_scores=False), mode, device="cpu",
            table_dtype="int8")
    gcfg = tgqe.GQEConfig(n_entities=300, n_modes=4, n_rels=12,
                          embed_dim=16, decoder="box")
    gmodel = tgqe.init_gqe(torch.Generator().manual_seed(0), gcfg)
    for td in QUANT:
        with pytest.raises(ValueError, match="box-decoder serving"):
            tserve.QueryServer(gmodel, gcfg, mode, device="cpu",
                               table_dtype=td)
    # a box model serves the raw table: no candidate table is built
    assert tserve.QueryServer(gmodel, gcfg, mode,
                              device="cpu")._ent_norm_t is None


@pytest.fixture(scope="module")
def trained():
    from mpqe_tpu_torch.queries import group_queries_by_formula
    from mpqe_tpu_torch.train import loop as tloop

    kg = tsamp.make_rule_kg(n_entities=200, n_modes=2, n_base_rels=4,
                            out_degree=1, seed=11)
    sampler = tsamp.QuerySampler(kg, seed=1)
    train_q = group_queries_by_formula(
        sampler.all_edge_queries(n_neg=16)
        + sampler.sample_queries("2-chain", 400, n_neg=16)
        + sampler.sample_queries("2-inter", 300, n_neg=16))
    cfg = tm.MPQEConfig(n_entities=kg.n_entities, n_modes=kg.n_modes,
                        n_rels=kg.n_rels, embed_dim=32, n_layers=2,
                        num_bases=4, readout="tgt")
    tc = tloop.TrainConfig(lr=0.01, batch_size=128, n_neg=8, max_steps=400,
                           conv_tol=1e-5, conv_window=60, val_every=100_000)
    state = tloop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                   tc, device="cpu")
    state = tloop.run_train(state, cfg, tc, train_q)
    return kg, cfg, state, sampler


@pytest.mark.parametrize("table_dtype", QUANT)
def test_server_quantized_table_recall(trained, table_dtype):
    # the counterpart of tests/test_serve.py:183
    kg, cfg, state, sampler = trained
    f32 = tserve.QueryServer(state.model, cfg, kg.entity_mode, device="cpu")
    qt = tserve.QueryServer(state.model, cfg, kg.entity_mode, device="cpu",
                            table_dtype=table_dtype)
    qs = (sampler.sample_queries("1-chain", 15, n_neg=1)
          + sampler.sample_queries("2-chain", 15, n_neg=1))
    a_f = f32.answer(qs, k=10)
    a_q = qt.answer(qs, k=10)
    overlaps = [
        len(set(f.entity_ids.tolist()) & set(q.entity_ids.tolist())) / 10
        for f, q in zip(a_f, a_q)]
    assert np.mean(overlaps) >= 0.8, np.mean(overlaps)
    for f, q in zip(a_f, a_q):
        np.testing.assert_allclose(q.scores, f.scores, atol=0.05)


def test_candidate_table_in_chunks_equals_whole(monkeypatch):
    rng = np.random.default_rng(0)
    ent = torch.from_numpy(rng.normal(size=(70, 8)).astype(np.float32))
    for td in ("float32", "bfloat16", "int8"):
        whole = trs.quantize_table(ent, td, True) if td != "float32" else \
            tm._l2_normalize(ent)
        monkeypatch.setattr(tserve, "TABLE_CHUNK_ROWS", 16)
        got = tserve.candidate_table(ent, True, td)
        assert torch.equal(got, whole), td
    # an f32 dot-product table is the model's own (no copy)
    assert tserve.candidate_table(ent, False,
                                  "float32").data_ptr() == ent.data_ptr()


def test_port_query_is_the_jax_query():
    # the samplers above give the same queries in both packages
    jqs, tqs, _ = _queries(n_per=2)
    for a, b in zip(jqs, tqs):
        assert isinstance(b, tq.Query)
        assert (a.formula.structure, a.formula.rels, a.anchors,
                a.target) == (b.formula.structure, b.formula.rels,
                              b.anchors, b.target)
