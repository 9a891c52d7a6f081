"""K4a / K4b and the sparse encoder's ``"pallas"`` segment backend against
the JAX package on the CPU.

* The plain K4a and K4b (``ops/segment_kernels.py``, what the wrappers run
  for CPU tensors and what the card is held to) against
  ``segment_sum_pallas`` / ``segment_max_pallas`` in interpret mode: sums
  to 1e-5 relative (both f32; the interpret kernel sums a chunk by a
  one-hot matmul, the port row by row in ascending order), maxima
  exactly.  Interpret-mode shapes stay small (S <= 64, E <= ~600): the
  max kernel unrolls per segment.
* The caps and the grad refusals, each beside the JAX kernel's own.
* ``encode_sparse(segment_backend="pallas")`` for the 7 structures and 5
  readouts against JAX ``encode_sparse(segment_backend="xla")`` (1e-5
  relative, f32 on both sides) and JAX ``encode_dense`` (3e-4, the
  reference's own dense-vs-sparse tolerance, tests/test_model.py:74).
  JAX's ``"pallas"`` backend cannot run on the CPU (its kernels are called
  without ``interpret``), so the slice is held to its ``"xla"`` path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.data import batcher as jbatch
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import pallas_segment as jps
from mpqe_tpu.ops import segment as jseg
from mpqe_tpu.queries import STRUCTURE_NAMES, STRUCTURES
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.data import batcher as tbatch
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import segment as tseg
from mpqe_tpu_torch.ops import segment_kernels as tsk

N_ENT, N_MODES, N_RELS, D = 40, 3, 6, 16
READOUTS = ("tgt", "sum", "max", "concat", "mlp")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- K4a / K4b
@pytest.mark.parametrize("e,d,s", [(100, 16, 10), (513, 128, 40), (7, 5, 3),
                                   (600, 16, 64)])
def test_plain_k4a_matches_pallas_interpret(e, d, s):
    rng = np.random.default_rng(e + s)
    data = rng.normal(size=(e, d)).astype(np.float32)
    ids = rng.integers(-2, s + 2, e).astype(np.int32)  # some out of range
    want = np.asarray(jps.segment_sum_pallas(jnp.asarray(data),
                                             jnp.asarray(ids), s,
                                             interpret=True))
    got = tsk.segment_sum_kernel(_t(data), _t(ids), s)
    assert got.shape == (s, d) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jseg.segment_sum(jnp.asarray(data),
                                                 jnp.asarray(ids), s)),
        rtol=0, atol=1e-5)


def test_plain_k4a_out_of_range_matches_pallas_interpret():
    # the reference's own case (tests/test_pallas_segment.py:20-25)
    data = np.ones((10, 8), dtype=np.float32)
    ids = np.array([0, 1, 2, 3, 4, 99, 99, -1, 2, 0], dtype=np.int32)
    want = np.asarray(jps.segment_sum_pallas(jnp.asarray(data),
                                             jnp.asarray(ids), 5,
                                             interpret=True))
    np.testing.assert_array_equal(
        tsk.segment_sum_kernel(_t(data), _t(ids), 5).numpy(), want)


@pytest.mark.parametrize("e,d,s", [(100, 16, 10), (513, 128, 40),
                                   (300, 16, 64)])
def test_plain_k4b_matches_pallas_interpret(e, d, s):
    rng = np.random.default_rng(e + s + 1)
    data = rng.normal(size=(e, d)).astype(np.float32) - 3.0
    ids = rng.integers(-1, s + 1, e).astype(np.int32)
    ids[ids == 2] = s  # segment 2 stays empty: NEG_INF, as in the kernel
    want = np.asarray(jps.segment_max_pallas(jnp.asarray(data),
                                             jnp.asarray(ids), s,
                                             interpret=True))
    got = tsk.segment_max_kernel(_t(data), _t(ids), s)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[2] == np.float32(tsk.NEG_INF)).all()


def test_plain_k4_keep_dtype_and_nan():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(40, 8)).astype(np.float32)
    ids = rng.integers(0, 6, 40).astype(np.int32)
    data[ids == 1, 3] = np.nan
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    # max: NaN propagates into its own segment, as jnp.maximum does
    want_max = np.asarray(jps.segment_max_pallas(jd, ji, 6, interpret=True))
    # sum: a NaN adds into its own segment only, as jax.ops.segment_sum
    # does; the interpret kernel's one-hot matmul also spreads it (0 * NaN)
    # into every segment of its chunk (ROADMAP Queue 3)
    want_sum = np.asarray(jseg.segment_sum(jd, ji, 6))
    for fn, want in ((tsk.segment_sum_kernel, want_sum),
                     (tsk.segment_max_kernel, want_max)):
        got = fn(_t(data), _t(ids), 6).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[1, 3]) and np.isnan(got).sum() == 1
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                                   rtol=1e-6, atol=1e-6)
        half = fn(_t(data).to(torch.bfloat16), _t(ids), 6)
        assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("fn,jfn", [
    (tsk.segment_sum_kernel, jps.segment_sum_pallas),
    (tsk.segment_max_kernel, jps.segment_max_pallas)], ids=["K4a", "K4b"])
def test_k4_segment_cap(fn, jfn):
    data = np.ones((4, 4), dtype=np.float32)
    ids = np.zeros(4, dtype=np.int32)
    for n in (jps.MAX_PALLAS_SEGMENTS + 1, 9000):
        with pytest.raises(ValueError):
            jfn(jnp.asarray(data), jnp.asarray(ids), n, interpret=True)
        with pytest.raises(ValueError, match="too large"):
            fn(_t(data), _t(ids), n)
    assert tsk.MAX_PALLAS_SEGMENTS == jps.MAX_PALLAS_SEGMENTS
    assert tsk.NEG_INF == jps.NEG_INF
    assert fn(_t(data), _t(ids), jps.MAX_PALLAS_SEGMENTS).shape == (
        jps.MAX_PALLAS_SEGMENTS, 4)


@pytest.mark.parametrize("fn,jfn", [
    (tsk.segment_sum_kernel, jps.segment_sum_pallas),
    (tsk.segment_max_kernel, jps.segment_max_pallas)], ids=["K4a", "K4b"])
def test_k4_is_forward_only_like_the_reference(fn, jfn):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(20, 4)).astype(np.float32)
    ids = rng.integers(0, 5, 20).astype(np.int32)
    # the reference kernel has no VJP: jax.grad through it fails
    with pytest.raises(Exception):
        jax.grad(lambda x: jnp.sum(jfn(x, jnp.asarray(ids), 5,
                                       interpret=True)))(jnp.asarray(data))
    x = _t(data).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward only"):
        fn(x, _t(ids), 5)
    with torch.no_grad():  # the same call without grad mode runs
        assert fn(x, _t(ids), 5).shape == (5, 4)


def test_segment_ops_pallas_backend_match_jax():
    rng = np.random.default_rng(8)
    n, E = 7, 40
    data = rng.normal(size=(E, 5)).astype(np.float32)
    ids = rng.integers(-1, n + 2, E).astype(np.int32)
    ids[ids == 3] = n  # segment 3 stays empty
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    td, ti = _t(data), _t(ids)
    np.testing.assert_allclose(
        tseg.segment_sum(td, ti, n, backend="pallas").numpy(),
        jseg.segment_sum(jd, ji, n), rtol=0, atol=1e-6)
    for empty in (0.0, -2.5):
        np.testing.assert_array_equal(
            tseg.segment_max(td, ti, n, backend="pallas",
                             empty_value=empty).numpy(),
            jseg.segment_max(jd, ji, n, empty_value=empty))
    np.testing.assert_allclose(
        tseg.segment_mean(td, ti, n, backend="pallas").numpy(),
        jseg.segment_mean(jd, ji, n), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown segment backend"):
        tseg.segment_sum(td, ti, n, backend="triton")


# ------------------------------------------------- encode_sparse, pallas
@functools.lru_cache(maxsize=None)
def _models(readout, nb=3):
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=D,
              n_layers=3, num_bases=nb, readout=readout)
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(2)
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


def _dense_batches(structure, B=8, seed=0):
    """The same random dense batch as the reference's and the port's
    ``DenseQueryBatch``."""
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    rels = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
    arrays = dict(
        node_entity=rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(
            np.int32),
        node_mode=rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(
            np.int32),
        edge_rel=rels,
        edge_norm=jbatch.template_edge_norm(spec, rels),
        target=np.zeros(B, np.int32), negatives=np.zeros((B, 1), np.int32),
        neg_mask=np.ones((B, 1), np.float32),
        query_mask=np.ones(B, np.float32))
    return (jbatch.DenseQueryBatch(structure, B, **arrays),
            tbatch.DenseQueryBatch(structure, B, **arrays))


def _sparse_args(sb):
    return (sb.node_entity, sb.node_mode, sb.node_is_var, sb.edges.src,
            sb.edges.dst, sb.edges.rel, sb.edges.norm, sb.node_query,
            sb.target_node)


@pytest.mark.parametrize("readout", READOUTS)
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_encode_sparse_pallas_matches_jax(structure, readout):
    jcfg, tcfg, params, model = _models(readout)
    jb, tb = _dense_batches(structure, seed=len(structure))
    jsb = jbatch.dense_to_sparse(jb, N_RELS)
    tsb = tbatch.dense_to_sparse(tb, N_RELS)
    B = tb.batch_size
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.encode_sparse(
            params, jcfg, structure, *map(jnp.asarray, _sparse_args(jsb)),
            n_queries=B, segment_backend="xla"))
        dense = np.asarray(jm.encode_dense(
            params, jcfg, structure, *(jnp.asarray(getattr(jb, f)) for f in (
                "node_entity", "node_mode", "edge_rel", "edge_norm"))))
    a0 = tsk.segment_sum_kernel.launches
    with torch.no_grad():
        got = tm.encode_sparse(model, tcfg, structure,
                               *map(_t, _sparse_args(tsb)), B,
                               segment_backend="pallas").numpy()
    assert tsk.segment_sum_kernel.launches == a0  # CPU: the plain version
    assert got.shape == (B, D)
    assert _rel(got, want) <= 1e-5, (structure, readout, _rel(got, want))
    np.testing.assert_allclose(got, dense, rtol=3e-4, atol=3e-4)


def test_encode_sparse_pallas_is_forward_only():
    _, tcfg, _, model = _models("tgt")
    _, tb = _dense_batches("2-chain")
    args = map(_t, _sparse_args(tbatch.dense_to_sparse(tb, N_RELS)))
    with pytest.raises(NotImplementedError, match="forward only"):
        tm.encode_sparse(model, tcfg, "2-chain", *args, tb.batch_size,
                         segment_backend="pallas")


# ------------------------------------------------------- the K4 layout
def _layout_cases():
    """(name, ids, S): ids out of range above and below, negative, empty
    segments, a sorted destination list, no rows, no segments."""
    rng = np.random.default_rng(21)
    ids = rng.integers(-3, 14, 300).astype(np.int32)
    ids[ids == 5] = 11  # segment 5 stays empty
    yield "mixed", ids, 11
    yield "sorted", np.sort(rng.integers(0, 40, 500)).astype(np.int64), 64
    yield "negative_only", np.full(17, -1, np.int32), 4
    yield "no_rows", np.zeros(0, np.int32), 8
    yield "no_segments", rng.integers(-2, 3, 9).astype(np.int32), 0
    yield "one_segment", np.zeros(33, np.int64), 1


@pytest.mark.parametrize("case", list(_layout_cases()), ids=lambda c: c[0])
def test_k4_with_a_given_layout_equals_without(case):
    _, ids_np, S = case
    rng = np.random.default_rng(len(ids_np) + S)
    data = _t(rng.normal(size=(len(ids_np), 6)).astype(np.float32))
    data[1::7, 2] = float("nan") if len(ids_np) > 1 else 0.0
    ids = _t(ids_np)
    layout = tsk.segment_layout(ids, S)
    perm, offs = layout
    assert perm.dtype == offs.dtype == torch.int32
    assert perm.shape == (len(ids_np),) and offs.shape == (S + 1,)
    # the stable sort by segment, out-of-range rows last in row order
    key = np.where((ids_np >= 0) & (ids_np < S), ids_np, S)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(
        offs.numpy(), np.searchsorted(np.sort(key), np.arange(S + 1)))
    for fn in (tsk.segment_sum_kernel, tsk.segment_max_kernel,
               tsk.segment_sum_reference, tsk.segment_max_reference):
        want = fn(data, ids, S)
        got = fn(data, ids, S, layout=layout)
        assert torch.equal(got.isnan(), want.isnan()), fn.__name__
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), fn.__name__
    for op in (tseg.segment_sum, tseg.segment_mean, tseg.segment_max):
        want = op(data, ids, S, backend="pallas")
        got = op(data, ids, S, backend="pallas", layout=layout)
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), op.__name__


def test_segment_mean_builds_one_layout(monkeypatch):
    calls = []
    real = tsk.segment_layout

    def counted(ids, n):
        calls.append(n)
        return real(ids, n)

    monkeypatch.setattr(tsk, "segment_layout", counted)
    rng = np.random.default_rng(4)
    data = _t(rng.normal(size=(50, 3)).astype(np.float32))
    ids = _t(rng.integers(-1, 9, 50).astype(np.int32))
    got = tseg.segment_mean(data, ids, 8, backend="pallas")
    assert calls == [8]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jseg.segment_mean(jnp.asarray(data.numpy()),
                                                  jnp.asarray(ids.numpy()),
                                                  8)), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="pallas"):
        tseg.segment_sum(data, ids, 8, layout=real(ids, 8))
    with pytest.raises(ValueError, match="too large"):
        tsk.segment_layout(ids, 9000)


@pytest.mark.parametrize("readout", READOUTS)
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_encode_sparse_pallas_builds_each_layout_once(structure, readout,
                                                      monkeypatch):
    jcfg, tcfg, params, model = _models(readout)
    jb, tb = _dense_batches(structure, seed=len(structure) + 1)
    jsb = jbatch.dense_to_sparse(jb, N_RELS)
    tsb = tbatch.dense_to_sparse(tb, N_RELS)
    B = tb.batch_size
    args = list(map(_t, _sparse_args(tsb)))
    built = []
    real = tsk.segment_layout

    def counted(ids, n):
        built.append((ids, n))
        return real(ids, n)

    monkeypatch.setattr(tsk, "segment_layout", counted)
    with torch.no_grad():
        got = tm.encode_sparse(model, tcfg, structure, *args, B,
                               segment_backend="pallas").numpy()
    want_built = [(args[4], tsb.n_nodes)]  # edge_dst, once for all layers
    if readout in ("sum", "mlp", "max"):
        want_built.append((args[7], B))  # node_query
    assert len(built) == len(want_built), (structure, readout, built)
    for (ids, n), (want_ids, want_n) in zip(built, want_built):
        assert ids is want_ids and n == want_n
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.encode_sparse(
            params, jcfg, structure, *map(jnp.asarray, _sparse_args(jsb)),
            n_queries=B, segment_backend="xla"))
    assert _rel(got, want) <= 1e-5, (structure, readout, _rel(got, want))
