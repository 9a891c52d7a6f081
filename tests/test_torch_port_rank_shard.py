"""The sharded full rank and top-k (``mpqe_tpu_torch/parallel/rank_shard.py``)
on ``["cpu"] * 8`` against the JAX package's (``shard_map`` on the
conftest's 8 CPU devices), mirroring ``tests/test_rank_shard.py``: the
same table, modes and query vectors on both sides; ranks equal element
for element, top-k ids equal, scores within 1e-6, the scarce-mode
``(-inf, -1)`` tail.  The port pads an int8 table's blocks to a multiple
of 8 rows (the card's int8 product wants it): the answers equal JAX's,
whose blocks are not padded so.  bfloat16 scores agree within
``BF16_TOL``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.parallel import mesh as jmesh
from mpqe_tpu.parallel import rank_shard as jrs
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.parallel import mesh as tmesh
from mpqe_tpu_torch.parallel import rank_shard as trs

D = 16
N_ENT = 109  # not divisible by 8: the row padding
N_MODES = 3
# bfloat16 scores against the jitted reference: measured 2.0e-4 on scores
# <= 1.  Both sides' bf16 products are exact in f32 outside shard_map, so
# the likely source is a last-bit difference in the normalized query
# moving one element's bf16 rounding by a bf16 step
BF16_TOL = 1e-3


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=6, embed_dim=D,
              n_layers=2, num_bases=None, readout="tgt")
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    entity_mode = rng.integers(0, N_MODES, N_ENT).astype(np.int32)
    B = 24
    q = rng.normal(size=(B, D)).astype(np.float32)
    target = rng.integers(0, N_ENT, B).astype(np.int32)
    jmsh = jmesh.make_mesh((1, 8), devices=jax.devices()[:8])
    tmsh = tmesh.make_mesh((1, 8), devices=["cpu"] * 8)
    model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model,
                mode=entity_mode, q=q, target=target, jmsh=jmsh, tmsh=tmsh)


def _ent(s):
    return np.array(s["params"]["emb"]["ent"])


def _ranks(s, cfg_kw=None, q=None, mode=None):
    jcfg = dataclasses.replace(s["jcfg"], **(cfg_kw or {}))
    tcfg = dataclasses.replace(s["tcfg"], **(cfg_kw or {}))
    q = s["q"] if q is None else q
    mode = s["mode"] if mode is None else mode
    ent_s, mode_s, _ = jrs.shard_table(s["jmsh"], jnp.asarray(_ent(s)),
                                       jnp.asarray(mode))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jrs.make_sharded_rank_fn(s["jmsh"], jcfg)(
            ent_s, mode_s, jnp.asarray(q), jnp.asarray(s["target"])))
    blocks, modes, n_pad = trs.shard_table(s["tmsh"], torch.tensor(_ent(s)),
                                           mode)
    assert n_pad == 112 and [b.shape[0] for b in blocks] == [14] * 8
    got = trs.make_sharded_rank_fn(s["tmsh"], tcfg)(
        blocks, modes, torch.from_numpy(np.asarray(q)),
        torch.from_numpy(s["target"]))
    return got.numpy(), want


def _dense_rank(cfg, ent, entity_mode, q, target):
    """The unsharded ``full_ranking`` count, in numpy from the port's
    ``score_all_entities``."""
    model_ent = torch.from_numpy(ent)

    class M:
        class emb:
            ent = model_ent

    scores = tm.score_all_entities(M, cfg, torch.from_numpy(
        np.asarray(q))).numpy()
    mode_ok = entity_mode[None, :] == entity_mode[target][:, None]
    scores = np.where(mode_ok, scores, -np.inf)
    true_s = scores[np.arange(len(target)), target]
    return 1 + (scores > true_s[:, None]).sum(axis=1)


@pytest.mark.parametrize("scale", [True, False], ids=["cosine", "dot"])
def test_sharded_rank_matches_jax(setup, scale):
    got, want = _ranks(setup, {"scale_scores": scale})
    np.testing.assert_array_equal(got, want)
    cfg = dataclasses.replace(setup["tcfg"], scale_scores=scale)
    np.testing.assert_array_equal(
        got, _dense_rank(cfg, _ent(setup), setup["mode"], setup["q"],
                         setup["target"]))


def _topk(s, k, mode, answer_mode, table_dtype="float32"):
    table = _ent(s)
    scale = bool(s["jcfg"].scale_scores)
    jt = jrs.quantize_table(jnp.asarray(table), table_dtype, scale)
    ent_s, mode_s, _ = jrs.shard_table(s["jmsh"], jt, jnp.asarray(mode))
    with jax.default_matmul_precision("highest"):
        jv, ji = jrs.make_sharded_topk_fn(s["jmsh"], s["jcfg"], k,
                                          table_dtype)(
            ent_s, mode_s, jnp.asarray(s["q"]), jnp.asarray(answer_mode))
    tt = trs.quantize_table(torch.from_numpy(table), table_dtype, scale)
    blocks, modes, _ = trs.shard_table(s["tmsh"], tt, mode)
    tv, ti = trs.make_sharded_topk_fn(s["tmsh"], s["tcfg"], k, table_dtype)(
        blocks, modes, torch.from_numpy(s["q"]),
        torch.from_numpy(np.asarray(answer_mode)))
    return (tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji),
            [b.shape[0] for b in blocks])


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_sharded_topk_matches_jax(setup, table_dtype):
    mode = setup["mode"]
    answer_mode = mode[setup["target"]]
    tv, ti, jv, ji, rows = _topk(setup, 7, mode, answer_mode, table_dtype)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=BF16_TOL
                               if table_dtype == "bfloat16" else 1e-6)
    assert ti.max() < N_ENT and (ti >= 0).all()
    # every id has the answer's mode; int8 blocks are 16 rows (14 -> a
    # multiple of 8), the others 14
    assert (mode[ti] == answer_mode[:, None]).all()
    assert rows == [16 if table_dtype == "int8" else 14] * 8
    if table_dtype == "int8":
        np.testing.assert_array_equal(tv, jv)  # int32 sums: exact


def test_sharded_rank_with_the_model_encoder(setup):
    """End to end: query vectors from the port's encoder, ranked by the
    sharded count and by the unsharded ``full_ranking`` count."""
    from mpqe_tpu_torch.queries import STRUCTURES

    rng = np.random.default_rng(3)
    spec = STRUCTURES["2-chain"]
    B = 16
    ne = rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32)
    nm = rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32)
    er = rng.integers(0, 6, (spec.n_edges,)).astype(np.int32)
    en = np.ones((spec.n_edges,), np.float32)
    target = rng.integers(0, N_ENT, B).astype(np.int32)
    with torch.no_grad():
        q = tm.encode_dense(setup["model"], setup["tcfg"], "2-chain",
                            *map(torch.from_numpy, (ne, nm, er, en)))
    blocks, modes, _ = trs.shard_table(setup["tmsh"], torch.from_numpy(
        _ent(setup)), setup["mode"])
    got = trs.make_sharded_rank_fn(setup["tmsh"], setup["tcfg"])(
        blocks, modes, q, torch.from_numpy(target)).numpy()
    np.testing.assert_array_equal(got, _dense_rank(
        setup["tcfg"], _ent(setup), setup["mode"], q.numpy(), target))


def test_sharded_topk_scarce_mode_returns_sentinel_ids(setup):
    em = np.zeros(N_ENT, np.int32)
    em[:2] = 1  # exactly two entities of mode 1
    answer_mode = np.ones(setup["q"].shape[0], np.int32)
    tv, ti, jv, ji, _ = _topk(setup, 5, em, answer_mode)
    np.testing.assert_array_equal(ti, ji)
    assert np.isfinite(tv[:, :2]).all() and set(ti[:, :2].flat) <= {0, 1}
    assert (~np.isfinite(tv[:, 2:])).all() and (ti[:, 2:] == -1).all()
