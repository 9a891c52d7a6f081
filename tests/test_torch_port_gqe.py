"""The port's GQE baselines (``mpqe_tpu_torch/models/gqe.py`` and
``aggregators.py``) against the JAX package on the CPU: the neighbor
table (equal, array for array), the neighborhood encoder, the query
encoders for all 5 decoders over all 7 structures, the scoring paths
with and without SoftAnd, the chunked all-entity box scores, and the
batch loss with its gradients.

The KG is ``tests/test_gqe.py``'s (100 entities, 2 modes, 4 base
relations) at d = 16.  Inputs come from numpy with a seed; parameters
from the JAX ``init_gqe`` (biases made non-zero), carried across with
``convert.gqe_from_numpy``.  Both sides compute in float32 and differ
only in sum order, so every comparison is held to 1e-5 of the
reference's largest magnitude (per leaf for gradients).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.models import aggregators as jagg
from mpqe_tpu.models import gqe as jgqe
from mpqe_tpu.queries import (INTERSECTION_STRUCTURES, STRUCTURE_NAMES,
                              STRUCTURES)
from mpqe_tpu_torch import convert
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.models import aggregators as tagg
from mpqe_tpu_torch.models import gqe as tgqe

KG = dict(n_entities=100, n_modes=2, n_base_rels=4, n_triples=400, seed=17)
D, B, K = 16, 8, 5
TOL = 1e-5
DECODERS = jgqe.DECODERS
# leaves whose gradient is zero in exact arithmetic: the box centers'
# attention is a softmax over the branches, which a bias shared by every
# branch does not move
ZERO_GRAD = {"box_att2_b"}


@functools.lru_cache(maxsize=None)
def _kgs():
    return jsamp.make_random_kg(**KG), tsamp.make_random_kg(**KG)


def _tables(fanout=8):
    jkg, tkg = _kgs()
    jt = jagg.build_neighbor_table(jkg, fanout=fanout, seed=3)
    tt = tagg.build_neighbor_table_device(tkg, fanout=fanout, seed=3,
                                          device="cpu")
    return {k: jnp.asarray(v) for k, v in jt.items()}, tt


def _models(seed=0, **kw):
    """(JAX cfg, port cfg, JAX params, port model) with non-zero biases."""
    jkg, _ = _kgs()
    base = dict(n_entities=jkg.n_entities, n_modes=jkg.n_modes,
                n_rels=jkg.n_rels, embed_dim=D, **kw)
    jcfg, tcfg = jgqe.GQEConfig(**base), tgqe.GQEConfig(**base)
    params = jax.tree.map(np.asarray,
                          jgqe.init_gqe(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def bias(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                bias(v)
            elif k.endswith("_b") or k.startswith("b_"):
                tree[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)

    bias(params)
    model = convert.gqe_from_numpy(params, tcfg, "cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), model


def _inputs(structure, seed=0, per_query=False):
    spec = STRUCTURES[structure]
    jkg, _ = _kgs()
    rng = np.random.default_rng(seed)
    ne = rng.integers(0, jkg.n_entities, (B, spec.n_nodes)).astype(np.int32)
    shape = (B, spec.n_edges) if per_query else (spec.n_edges,)
    er = rng.integers(0, jkg.n_rels, shape).astype(np.int32)
    tgt = rng.integers(0, jkg.n_entities, (B,)).astype(np.int32)
    neg = rng.integers(0, jkg.n_entities, (B, K)).astype(np.int32)
    return ne, er, tgt, neg


def _flat(rep):
    """The arrays of a representation (a vector, a box pair or a bibox
    pair), as numpy."""
    if isinstance(rep, (tuple, list)):
        return [a for r in rep for a in _flat(r)]
    if isinstance(rep, torch.Tensor):
        return [rep.detach().numpy()]
    return [np.asarray(rep)]


def _close(got, want, tol=TOL, what=""):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-12)
        assert err <= tol, (what, err)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------------- neighbor table
@pytest.mark.parametrize("fanout", [3, 8])
def test_neighbor_table_equals_jax(fanout):
    jkg, tkg = _kgs()
    want = jagg.build_neighbor_table(jkg, fanout=fanout, seed=5)
    got = tagg.build_neighbor_table(tkg, fanout=fanout, seed=5)
    assert set(got) == set(want) == {"idx", "mask"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    dev = tagg.build_neighbor_table_device(tkg, fanout=fanout, seed=5,
                                           device="cpu")
    for k in want:
        np.testing.assert_array_equal(dev[k].numpy(), want[k])


@pytest.mark.parametrize("aggregator", tagg.AGGREGATORS)
def test_encode_entities_matches_jax(aggregator):
    _, _, params, model = _models(encoder="neighborhood",
                                  aggregator=aggregator)
    jt, tt = _tables(fanout=4)
    # one row with every neighbor masked: max and pool give 0 there
    jt = {"idx": jt["idx"], "mask": jt["mask"].at[7].set(0.0)}
    tt = {"idx": tt["idx"], "mask": tt["mask"].clone()}
    tt["mask"][7] = 0.0
    ids = np.random.default_rng(1).integers(0, 100, (6, 3)).astype(np.int32)
    ids[0, 0] = 7
    with jax.default_matmul_precision("highest"):
        want = jagg.encode_entities(params["nbr"], params["emb"]["ent"],
                                    jt["idx"], jt["mask"], jnp.asarray(ids),
                                    aggregator)
    got = tagg.encode_entities(model.nbr, model.emb.ent, tt["idx"],
                               tt["mask"], torch.from_numpy(ids), aggregator)
    assert tuple(got.shape) == (6, 3, D)
    _close(got, want, what=aggregator)


def test_neighborhood_init_distributions():
    gen = torch.Generator().manual_seed(0)
    enc = tagg.init_neighborhood_encoder(gen, 64, "pool")
    assert sorted(n for n, _ in enc.named_parameters()) == [
        "b_combine", "b_pool", "w_combine", "w_pool"]
    assert tuple(enc.w_combine.shape) == (128, 64)
    for w in (enc.w_combine.detach(), enc.w_pool.detach()):
        assert abs(float(w.std()) - (2.0 / 128) ** 0.5) < 0.01
    assert float(enc.b_combine.detach().abs().max()) == 0.0
    with pytest.raises(ValueError, match="aggregator"):
        tagg.NeighborhoodEncoder(8, "sum")


# ------------------------------------------------------------- encoders
@pytest.mark.parametrize("structure", STRUCTURE_NAMES)
@pytest.mark.parametrize("decoder", DECODERS)
def test_encode_dense_matches_jax(decoder, structure):
    jcfg, tcfg, params, model = _models(decoder=decoder)
    ne, er, _, _ = _inputs(structure)
    ne_q, er_q, _, _ = _inputs(structure, seed=1, per_query=True)
    with jax.default_matmul_precision("highest"):
        want = jgqe.encode_dense(params, jcfg, structure, jnp.asarray(ne),
                                 None, jnp.asarray(er), None)
        want_q = jgqe.encode_dense_multi(params, jcfg, structure,
                                         jnp.asarray(ne_q), None,
                                         jnp.asarray(er_q), None)
    got = tgqe.encode_dense(model, tcfg, structure, *_t(ne), None,
                            *_t(er), None)
    got_q = tgqe.encode_dense_multi(model, tcfg, structure, *_t(ne_q), None,
                                    *_t(er_q), None)
    _close(got, want, what="shared relations")
    _close(got_q, want_q, what="per-query relations")


@pytest.mark.parametrize("structure", sorted(INTERSECTION_STRUCTURES))
@pytest.mark.parametrize("intersection", ["min", "mean"])
@pytest.mark.parametrize("decoder", DECODERS)
def test_intersections_match_jax(decoder, intersection, structure):
    jcfg, tcfg, params, model = _models(decoder=decoder,
                                        intersection=intersection)
    ne, er, _, _ = _inputs(structure, seed=2, per_query=True)
    with jax.default_matmul_precision("highest"):
        want = jgqe.encode_dense_multi(params, jcfg, structure,
                                       jnp.asarray(ne), None,
                                       jnp.asarray(er), None)
    got = tgqe.encode_dense_multi(model, tcfg, structure, *_t(ne), None,
                                  *_t(er), None)
    _close(got, want)


# -------------------------------------------------------------- scoring
@pytest.mark.parametrize("soft_and", [False, True], ids=["and", "softand"])
@pytest.mark.parametrize("decoder", DECODERS)
def test_scores_match_jax(decoder, soft_and):
    jcfg, tcfg, params, model = _models(decoder=decoder, soft_and=soft_and,
                                        bibox_w=0.7)
    for i, structure in enumerate(("2-chain", "3-inter", "3-inter_chain",
                                   "3-chain_inter")):
        ne, er, tgt, neg = _inputs(structure, seed=10 + i,
                                   per_query=bool(i % 2))
        with jax.default_matmul_precision("highest"):
            jargs = [jnp.asarray(a) for a in (ne, er, tgt, neg)]
            want = jgqe.score_pos_neg(params, jcfg, structure, *jargs)
            want_1 = jgqe.score_queries(params, jcfg, structure, *jargs[:3])
            want_k = jgqe.score_queries(params, jcfg, structure, *jargs[:2],
                                        jargs[3])
        targs = _t(ne, er, tgt, neg)
        got = tgqe.score_pos_neg(model, tcfg, structure, *targs)
        _close(got, want, what=structure)
        _close(tgqe.score_queries(model, tcfg, structure, *targs[:3]),
               want_1, what=structure)
        _close(tgqe.score_queries(model, tcfg, structure, *targs[:2],
                                  targs[3]), want_k, what=structure)
        # the [B] and [B, K] paths agree with score_pos_neg
        _close(got[1], want_k)


@pytest.mark.parametrize("decoder", ["box", "bibox"])
def test_score_all_in_chunks_matches_jax(decoder, monkeypatch):
    # 100 entities in chunks of 7 (a partial last chunk) against the
    # reference's one padded chunk of 8192
    jcfg, tcfg, params, model = _models(decoder=decoder, bibox_w=0.4)
    monkeypatch.setattr(tgqe, "BOX_CHUNK_BYTES", 7 * 4 * B * D)
    ne, er, _, _ = _inputs("3-inter_chain", seed=4, per_query=True)
    with jax.default_matmul_precision("highest"):
        jrep = jgqe.encode_dense_multi(params, jcfg, "3-inter_chain",
                                       jnp.asarray(ne), None, jnp.asarray(er),
                                       None)
        fn = jgqe.box_score_all if decoder == "box" else jgqe.bibox_score_all
        want = fn(params, jcfg, jrep)
        jbox = jrep if decoder == "box" else jrep[1]
        want_rows = jgqe.box_score_rows(jcfg, jbox, params["emb"]["ent"][:9])
    trep = tgqe.encode_dense_multi(model, tcfg, "3-inter_chain", *_t(ne),
                                   None, *_t(er), None)
    tfn = tgqe.box_score_all if decoder == "box" else tgqe.bibox_score_all
    got = tfn(model, tcfg, trep)
    assert tuple(got.shape) == (B, 100)
    _close(got, want)
    tbox = trep if decoder == "box" else trep[1]
    _close(tgqe.box_score_rows(tcfg, tbox, model.emb.ent[:9]), want_rows)
    if decoder == "bibox":
        _close(tgqe.bibox_score_rows(tcfg, trep, model.emb.ent[:9]),
               jgqe.bibox_score_rows(jcfg, jrep, params["emb"]["ent"][:9]))
    # the chunk changes no score: one chunk gives the same bits
    monkeypatch.setattr(tgqe, "BOX_CHUNK_BYTES", 1 << 30)
    assert torch.equal(tfn(model, tcfg, trep), got)


# ----------------------------------------------------- loss and gradients
def _jax_loss_grad(params, jcfg, structure, arrays, nbr=None):
    def f(p):
        return jgqe.dense_batch_loss(p, jcfg, structure, *arrays,
                                     neighbor_table=nbr)

    with jax.default_matmul_precision("highest"):
        return jax.value_and_grad(f)(params)


def _batch_arrays(structure, seed):
    ne, er, tgt, neg = _inputs(structure, seed=seed)
    rng = np.random.default_rng(seed + 100)
    spec = STRUCTURES[structure]
    nm = np.zeros((B, spec.n_nodes), np.int32)
    en = np.ones((spec.n_edges,), np.float32)
    neg_mask = (rng.random((B, K)) > 0.2).astype(np.float32)
    qmask = np.ones(B, np.float32)
    qmask[-2:] = 0.0
    return ne, nm, er, en, tgt, neg, neg_mask, qmask


def _check_loss_and_grads(jcfg, tcfg, params, model, structures, jnbr=None,
                          tnbr=None):
    for i, structure in enumerate(structures):
        arrays = _batch_arrays(structure, 20 + i)
        loss_j, g_j = _jax_loss_grad(params, jcfg, structure,
                                     [jnp.asarray(a) for a in arrays], jnbr)
        model.zero_grad(set_to_none=True)
        loss_t = tgqe.dense_batch_loss(model, tcfg, structure, *_t(*arrays),
                                       neighbor_table=tnbr)
        loss_t.backward()
        assert abs(float(loss_t) - float(loss_j)) <= TOL * abs(
            float(loss_j)), structure
        want = convert.gqe_to_numpy(convert.gqe_from_numpy(
            jax.tree.map(np.asarray, g_j), tcfg, "cpu"))
        got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
               for n, p in model.named_parameters()}
        top = max(float(np.abs(v).max()) for v in jax.tree.leaves(g_j))
        for name, g in got.items():
            head, _, leaf = name.partition(".")
            w, g = (want[head][leaf] if leaf else want[head]), g.numpy()
            if name in ZERO_GRAD:
                # zero in exact arithmetic: both sides hold rounding noise
                assert max(np.abs(w).max(), np.abs(g).max()) <= 1e-6 * top
                continue
            err = np.abs(g - w).max() / (np.abs(w).max() + 1e-12)
            assert err <= TOL or np.abs(w).max() == 0 == np.abs(g).max(), (
                structure, name, err)


@pytest.mark.parametrize("soft_and", [False, True], ids=["and", "softand"])
@pytest.mark.parametrize("decoder", DECODERS)
def test_dense_batch_loss_and_grads_match_jax(decoder, soft_and):
    jcfg, tcfg, params, model = _models(decoder=decoder, soft_and=soft_and)
    _check_loss_and_grads(jcfg, tcfg, params, model,
                          ("3-chain", "3-inter", "3-chain_inter"))


@pytest.mark.parametrize("aggregator", tagg.AGGREGATORS)
def test_neighborhood_loss_and_grads_match_jax(aggregator):
    jcfg, tcfg, params, model = _models(encoder="neighborhood",
                                        aggregator=aggregator,
                                        decoder="bilinear")
    jt, tt = _tables(fanout=3)
    _check_loss_and_grads(jcfg, tcfg, params, model,
                          ("2-chain", "2-inter"), jt, tt)


# --------------------------------------------------- config and modules
def test_config_validation_and_dtype():
    kw = dict(n_entities=5, n_modes=1, n_rels=2)
    for field, bad in (("decoder", "rotate"), ("intersection", "max"),
                       ("encoder", "gnn"), ("aggregator", "sum")):
        with pytest.raises(ValueError, match=field):
            tgqe.GQEConfig(**kw, **{field: bad})
    assert tgqe.GQEConfig(**kw, dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="model dtype"):
        tgqe.GQEConfig(**kw, dtype=torch.float16)


@pytest.mark.parametrize("decoder", DECODERS)
def test_parameter_names_are_the_jax_leaves(decoder):
    jcfg, tcfg, params, _ = _models(decoder=decoder, encoder="neighborhood",
                                    aggregator="pool")
    model = tgqe.init_gqe(torch.Generator().manual_seed(0), tcfg)
    want = {f"{k}.{leaf}" if isinstance(v, dict) else k
            for k, v in params.items()
            for leaf in (v if isinstance(v, dict) else [None])}
    assert set(model.state_dict()) == want
    for name, p in model.named_parameters():
        head, _, leaf = name.partition(".")
        ref = params[head][leaf] if leaf else params[head]
        assert tuple(p.shape) == tuple(ref.shape), name
        assert torch.isfinite(p).all(), name
    # the round trip through the JAX layout is exact
    back = convert.gqe_from_numpy(convert.gqe_to_numpy(model), tcfg, "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n


def test_init_distributions():
    cfg = tgqe.GQEConfig(n_entities=50, n_modes=2, n_rels=6, embed_dim=64,
                         decoder="bibox")
    model = tgqe.init_gqe(torch.Generator().manual_seed(0), cfg)
    eye = torch.eye(64)
    noise = model.rel_mat.detach() - eye
    assert abs(float(noise.std()) - 0.1 / 8) < 2e-3
    off = model.rel_off.detach()
    assert float(off.min()) >= 0 and float(off.max()) <= 0.5 / 8
    assert abs(float(model.rel_cen.std()) - 1 / 8) < 0.01
    assert abs(float(model.box_ds1.std()) - (2 / 128) ** 0.5) < 0.01
    assert abs(float(model.int_pre.std()) - (2 / 128) ** 0.5) < 0.01
    for b in ("box_att1_b", "int_post_b"):
        assert float(getattr(model, b).abs().max()) == 0.0
    # the bilinear noise is drawn apart from the box centers
    again = tgqe.init_gqe(torch.Generator().manual_seed(0),
                          tgqe.GQEConfig(n_entities=50, n_modes=2, n_rels=6,
                                         embed_dim=64, decoder="bilinear"))
    assert not torch.equal(again.rel_mat, model.rel_mat)


def test_neighborhood_without_table_raises():
    _, tcfg, _, model = _models(encoder="neighborhood")
    ne, er, tgt, neg = _inputs("2-chain")
    with pytest.raises(ValueError, match="needs neighbor_table="):
        tgqe.score_pos_neg(model, tcfg, "2-chain", *_t(ne, er, tgt, neg))


def test_load_refuses_missing_and_misshaped_leaves():
    _, tcfg, params, _ = _models(decoder="box")
    tree = jax.tree.map(np.asarray, params)
    del tree["box_ds2_b"]
    with pytest.raises(ValueError, match=r"missing \['box_ds2_b'\]"):
        convert.gqe_from_numpy(tree, tcfg)
    tree = jax.tree.map(np.asarray, params)
    tree["rel_mat"] = np.zeros((2, 2, 2), np.float32)
    with pytest.raises(ValueError, match=r"unexpected \['rel_mat'\]"):
        convert.gqe_from_numpy(tree, tcfg)
    tree = jax.tree.map(np.asarray, params)
    tree["rel_cen"] = tree["rel_cen"][:, :3]
    with pytest.raises(ValueError, match="rel_cen: shape"):
        convert.gqe_from_numpy(tree, tcfg)
