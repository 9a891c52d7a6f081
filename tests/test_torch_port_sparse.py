"""The port's plain sparse path against the JAX package on the CPU: the
segment ops, ``embed_nodes_sparse``, ``readout_sparse``, the f32 sparse
layers and ``encode_sparse``, and every layout builder the sparse
kernels consume (array for array).  Inputs come from numpy with a seed;
parameters from the JAX ``init_mpqe``, carried across with
``model_from_numpy``.

Tolerances: gathers, selects, maxima and the layout builders are exact
(compared for equality); sums and f32 products differ only in summation
order, so the f32 layers and encoders agree to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import embeddings as jemb
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.models import readout as jro
from mpqe_tpu.ops import edge_store as jes
from mpqe_tpu.ops import pallas_rgcn as jpr
from mpqe_tpu.ops import pallas_rgcn_blocked as jprb
from mpqe_tpu.ops import rgcn as jrgcn
from mpqe_tpu.ops import segment as jseg
from mpqe_tpu.ops import template_layout as jtl
from mpqe_tpu.queries import STRUCTURE_NAMES, STRUCTURES
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.models import embeddings as temb
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.models import readout as tro
from mpqe_tpu_torch.ops import edge_store as tes
from mpqe_tpu_torch.ops import rgcn as trgcn
from mpqe_tpu_torch.ops import rgcn_blocked as tprb
from mpqe_tpu_torch.ops import rgcn_fused as tpr
from mpqe_tpu_torch.ops import segment as tseg
from mpqe_tpu_torch.ops import template_layout as ttl

N_ENT, N_MODES, N_RELS, D = 40, 3, 6, 16
READOUTS = ("tgt", "sum", "max", "concat", "mlp")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _models(nb=3, readout="tgt", seed=0, n_layers=2):
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=D,
              n_layers=n_layers, num_bases=nb, readout=readout)
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:  # non-zero biases (init is zeros)
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    for k in params["readout"]:
        if k.startswith("b_"):
            params["readout"][k] = jnp.asarray(
                0.1 * rng.normal(size=params["readout"][k].shape
                                 ).astype(np.float32))
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _graph(rng, n_nodes=50, n_e=200):
    src = rng.integers(0, n_nodes, n_e).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_e).astype(np.int32)
    rel = rng.integers(0, N_RELS, n_e).astype(np.int32)
    return src, dst, rel


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ segment ops
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_ops_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, E = 7, 40
    data = rng.normal(size=(E, 5)).astype(np.float32)
    # ids outside [0, n) are dropped; segment 3 stays empty
    ids = rng.integers(-1, n + 2, E).astype(np.int32)
    ids[ids == 3] = n
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    td, ti = _t(data), _t(ids)
    np.testing.assert_allclose(tseg.segment_sum(td, ti, n).numpy(),
                               jseg.segment_sum(jd, ji, n), rtol=0,
                               atol=1e-6)
    for empty in (0.0, -2.5):
        np.testing.assert_array_equal(
            tseg.segment_max(td, ti, n, empty_value=empty).numpy(),
            jseg.segment_max(jd, ji, n, empty_value=empty))
    np.testing.assert_allclose(tseg.segment_mean(td, ti, n).numpy(),
                               jseg.segment_mean(jd, ji, n), rtol=0,
                               atol=1e-6)
    ids_in = rng.integers(0, n, E).astype(np.int32)
    logits = rng.normal(size=(E,)).astype(np.float32)
    np.testing.assert_allclose(
        tseg.segment_softmax_weights(_t(logits), _t(ids_in), n).numpy(),
        jseg.segment_softmax_weights(jnp.asarray(logits),
                                     jnp.asarray(ids_in), n),
        rtol=1e-6, atol=1e-7)


def test_segment_pallas_backend_is_not_ported():
    # (named when the backend raised) the "pallas" backend is ported now
    # (K4a / K4b): it gives the "xla" backend's sums and maxima
    # (tests/test_torch_port_segment.py holds it to the Pallas interpret
    # kernels); an unknown backend raises
    x = torch.arange(6.0).reshape(3, 2)
    ids = torch.tensor([1, 0, 1], dtype=torch.int32)
    for op in (tseg.segment_sum, tseg.segment_max, tseg.segment_mean):
        np.testing.assert_array_equal(op(x, ids, 2, backend="pallas").numpy(),
                                      op(x, ids, 2).numpy())
    with pytest.raises(ValueError, match="unknown segment backend"):
        tseg.segment_sum(x, ids, 2, backend="tpu")


def test_scatter_add_dense_matches_jax():
    from mpqe_tpu.ops import embed as jembed
    from mpqe_tpu_torch.ops import embed as tembed

    rng = np.random.default_rng(3)
    g = rng.normal(size=(30, 4)).astype(np.float32)
    idx = rng.integers(0, 9, 30).astype(np.int32)
    np.testing.assert_allclose(
        tembed.scatter_add_dense(9, _t(idx), _t(g)).numpy(),
        jembed.scatter_add_dense(9, jnp.asarray(idx), jnp.asarray(g)),
        rtol=0, atol=1e-6)


# ------------------------------------------------ embeddings and readouts
@pytest.mark.parametrize("readout", READOUTS)
def test_embed_and_readout_sparse_match_jax(readout):
    _, _, params, model = _models(readout=readout)
    rng = np.random.default_rng(5)
    B, n = 6, 4
    ne = rng.integers(0, N_ENT, B * n).astype(np.int32)
    nm = rng.integers(0, N_MODES, B * n).astype(np.int32)
    niv = (rng.random(B * n) < 0.5).astype(np.float32)
    want_x = jemb.embed_nodes_sparse(params["emb"], jnp.asarray(ne),
                                     jnp.asarray(nm), jnp.asarray(niv))
    got_x = temb.embed_nodes_sparse(model.emb, _t(ne), _t(nm), _t(niv))
    np.testing.assert_array_equal(got_x.detach().numpy(), want_x)
    nq = np.repeat(np.arange(B), n).astype(np.int32)
    tn = (np.arange(B) * n + n - 1).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = jro.readout_sparse(readout, params["readout"], want_x,
                                  jnp.asarray(nq), jnp.asarray(tn), B,
                                  n_template_nodes=n)
    got = tro.readout_sparse(readout, model.readout, got_x, _t(nq), _t(tn),
                             B, n_template_nodes=n)
    assert got.shape == (B, D)
    assert _rel(got.detach().numpy(), want) <= 1e-5, readout


# --------------------------------------------------------- sparse layers
@pytest.mark.parametrize("nb", [3, None], ids=["basis", "full"])
def test_rgcn_sparse_layers_match_jax(nb):
    _, _, params, model = _models(nb)
    rng = np.random.default_rng(7)
    st = jes.build_edge_store(*_graph(rng), 50, N_RELS, capacity=230)
    x = rng.normal(size=(50, D)).astype(np.float32)
    args = (st.src, st.dst, st.rel, st.norm)
    with jax.default_matmul_precision("highest"):
        want = jrgcn.rgcn_sparse(jnp.asarray(x), params["layers"][0],
                                 *map(jnp.asarray, args), N_RELS)
        want_rb = jrgcn.rgcn_sparse_relblock(
            jnp.asarray(x), params["layers"][0], *map(jnp.asarray, args),
            N_RELS)
    with torch.no_grad():
        got = trgcn.rgcn_sparse(_t(x), model.layers[0], *map(_t, args),
                                N_RELS)
        got_rb = trgcn.rgcn_sparse_relblock(_t(x), model.layers[0],
                                            *map(_t, args), N_RELS)
    assert _rel(got.numpy(), want) <= 1e-5
    assert _rel(got_rb.numpy(), want_rb) <= 1e-5
    assert _rel(got.numpy(), got_rb.numpy()) <= 1e-5


@pytest.mark.parametrize("readout", READOUTS)
@pytest.mark.parametrize("structure", ["2-chain", "3-chain_inter", ""])
def test_encode_sparse_matches_jax(structure, readout):
    # a dense template batch in its sparse view (structure "" runs every
    # layer); the readout's parameters come across too
    jcfg, tcfg, params, model = _models(readout=readout, n_layers=3)
    s = structure or "3-chain_inter"
    spec = STRUCTURES[s]
    rng = np.random.default_rng(9)
    B = 8
    ne = rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32)
    nm = rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32)
    er = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
    en = rng.uniform(0.5, 1.5, spec.n_edges).astype(np.float32)
    jview = jm._sparse_view_on_device(s, jnp.asarray(ne), jnp.asarray(nm))
    tview = tm._sparse_view_on_device(s, _t(ne), _t(nm))
    for a, b in zip(jview[:5], tview[:5]):
        np.testing.assert_array_equal(b.numpy(), a)
    assert jview[5] == tview[5] == B
    ch = jtl.template_chunked(s, jnp.asarray(er), jnp.asarray(en), B, 8)
    rel = np.repeat(er, B)
    edges = (ch["src"], ch["dst"], rel, ch["norm"])
    if readout == "concat" and not structure:
        # both refuse: concat needs the template's node count
        with pytest.raises(ValueError, match="n_template_nodes"):
            jm.encode_sparse(params, jcfg, structure, *jview[:3],
                             *map(jnp.asarray, edges), *jview[3:5], B)
        with pytest.raises(ValueError, match="n_template_nodes"):
            tm.encode_sparse(model, tcfg, structure, *tview[:3],
                             *(_t(a) for a in edges), *tview[3:5], B)
        return
    with jax.default_matmul_precision("highest"):
        want = jm.encode_sparse(params, jcfg, structure, *jview[:3],
                                *map(jnp.asarray, edges), *jview[3:5], B)
    with torch.no_grad():
        got = tm.encode_sparse(model, tcfg, structure, *tview[:3],
                               *(_t(a) for a in edges),
                               *tview[3:5], B)
    assert got.shape == (B, D)
    assert _rel(got.numpy(), want) <= 1e-5, (structure, readout)


def test_encode_sparse_pallas_backend_raises():
    # (named when the backend raised) the "pallas" backend runs K4a (its
    # plain version here) and gives the "xla" backend's queries; like the
    # reference kernels it is forward only, so it raises in grad mode on
    # parameters that require grad
    _, tcfg, _, model = _models()
    z = torch.zeros(4, dtype=torch.int32)
    args = (model, tcfg, "", z, z, z.float(), z, z, z, z.float(), z, z[:1], 1)
    with pytest.raises(NotImplementedError, match="forward only"):
        tm.encode_sparse(*args, segment_backend="pallas")
    with torch.no_grad():
        np.testing.assert_array_equal(
            tm.encode_sparse(*args, segment_backend="pallas").numpy(),
            tm.encode_sparse(*args).numpy())


# --------------------------------------------------------- layout builders
def _assert_same_layout(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, (int, np.integer)):
            assert g == v, k
        else:
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_array_equal(g, np.asarray(v), k)
            assert np.asarray(g).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("capacity", [None, 260])
def test_edge_store_and_chunking_match_jax(capacity):
    rng = np.random.default_rng(11)
    src, dst, rel = _graph(rng, n_nodes=60, n_e=240)
    js = jes.build_edge_store(src, dst, rel, 60, N_RELS, capacity=capacity)
    ts = tes.build_edge_store(src, dst, rel, 60, N_RELS, capacity=capacity)
    for f in ("src", "dst", "rel", "norm", "rel_ptr"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), f)
    assert (ts.n_edges, ts.n_nodes, ts.n_rels, ts.capacity) == (
        js.n_edges, js.n_nodes, js.n_rels, js.capacity)
    np.testing.assert_array_equal(ts.pad_mask, js.pad_mask)
    assert tes.coo_roundtrip_check(ts) and jes.coo_roundtrip_check(js)
    assert tes.round_up(13, 8) == jes.round_up(13, 8) == 16
    np.testing.assert_array_equal(
        tes.compute_edge_norm(dst, rel, 60, N_RELS),
        jes.compute_edge_norm(dst, rel, 60, N_RELS))
    with pytest.raises(ValueError):
        tes.build_edge_store(src, dst, rel, 60, N_RELS, capacity=10)
    for chunk in (8, 32):
        _assert_same_layout(tpr.chunk_by_relation(ts, chunk),
                            jpr.chunk_by_relation(js, chunk))
    empty = tes.build_edge_store(src[:0], dst[:0], rel[:0], 60, N_RELS)
    _assert_same_layout(
        tpr.chunk_by_relation(empty, 8),
        jpr.chunk_by_relation(
            jes.build_edge_store(src[:0], dst[:0], rel[:0], 60, N_RELS), 8))


@pytest.mark.parametrize("node_block,chunk", [(16, 8), (32, 16), (64, 8)])
def test_bucket_edges_blocked_matches_jax(node_block, chunk):
    rng = np.random.default_rng(12)
    src, dst, rel = _graph(rng, n_nodes=70, n_e=300)
    js = jes.build_edge_store(src, dst, rel, 70, N_RELS)
    ts = tes.build_edge_store(src, dst, rel, 70, N_RELS)
    for with_t in (True, False):
        _assert_same_layout(
            tprb.bucket_edges_blocked(ts, node_block, chunk,
                                      with_transpose=with_t),
            jprb.bucket_edges_blocked(js, node_block, chunk,
                                      with_transpose=with_t))


def test_bucket_edges_blocked_refuses_sparse_occupancy():
    rng = np.random.default_rng(5)
    ts = tes.build_edge_store(*_graph(rng, n_nodes=4096, n_e=100), 4096,
                              N_RELS)
    with pytest.raises(ValueError, match="pad"):
        tprb.bucket_edges_blocked(ts, node_block=128, chunk=64)
    # the same graph passes once the ratio allows it, as in JAX
    js = jes.build_edge_store(ts.src, ts.dst, ts.rel, 4096, N_RELS)
    _assert_same_layout(
        tprb.bucket_edges_blocked(ts, 128, 64, max_pad_ratio=1e9),
        jprb.bucket_edges_blocked(js, 128, 64, max_pad_ratio=1e9))


@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_template_layouts_match_jax(structure):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(13)
    er = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
    en = rng.uniform(0.5, 1.5, spec.n_edges).astype(np.float32)
    for B, chunk in ((16, 8), (64, 16), (512, 512)):
        _assert_same_layout(
            ttl.template_chunked(structure, _t(er), _t(en), B, chunk),
            jtl.template_chunked(structure, jnp.asarray(er),
                                 jnp.asarray(en), B, chunk))
    for B, q, chunk in ((16, 8, 8), (128, 512, 512), (4096, 512, 512),
                        (512, 64, 16)):
        assert ttl.blocked_geometry(structure, B, q, chunk) == \
            jtl.blocked_geometry(structure, B, q, chunk)
        _assert_same_layout(
            ttl.template_blocked(structure, _t(er), _t(en), B, q, chunk),
            jtl.template_blocked(structure, jnp.asarray(er),
                                 jnp.asarray(en), B, q, chunk))
    with pytest.raises(ValueError):
        ttl.template_chunked(structure, _t(er), _t(en), 24, 16)
