"""K7 (``ops/sddmm.py``) against the JAX package on the CPU.

* The plain K7 (what the wrapper runs for CPU tensors and what the card is
  held to) against ``sddmm_pallas`` in interpret mode, 1e-5 relative:
  both f32, the interpret kernel gathers rows by one-hot matmuls and sums
  a row's products on the vector unit, the port over k ascending.
* Out-of-range endpoints score 0 (the reference's padding semantics,
  tests/test_sddmm.py:42); the cap at N = 8,192 nodes; forward only, as
  the reference kernel (whose ``jax.grad`` fails).
* ``sddmm_xla`` and ``sddmm_relational_xla`` against the JAX ones (1e-5:
  f32, sum order).
* K7 over a sparse batch's own edges, scoring the node embeddings of
  ``encode_sparse``'s last layer as the card check does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.ops import pallas_sddmm as jsd
from mpqe_tpu_torch.ops import sddmm as tsd


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, n, d, e):
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return x, y, src, dst


@pytest.mark.parametrize("n,d,e", [(50, 16, 200), (130, 128, 700),
                                   (64, 40, 300)])
def test_plain_k7_matches_pallas_interpret(n, d, e):
    rng = np.random.default_rng(n + e)
    x, y, src, dst = _case(rng, n, d, e)
    src[:3] = [-1, n, n + 9]  # out of range: score 0
    dst[5] = -3
    want = np.asarray(jsd.sddmm_pallas(*map(jnp.asarray, (x, y, src, dst)),
                                       chunk=64, interpret=True))
    got = tsd.sddmm_kernel(*map(_t, (x, y, src, dst)))
    assert got.shape == (e,) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    assert (got.numpy()[[0, 1, 2, 5]] == 0).all()
    assert (want[[0, 1, 2, 5]] == 0).all()
    np.testing.assert_allclose(
        got.numpy(), np.einsum("ed,ed->e", x.astype(np.float64)[
            src.clip(0, n - 1)], y.astype(np.float64)[dst.clip(0, n - 1)])
        * ((src >= 0) & (src < n) & (dst >= 0) & (dst < n)),
        rtol=1e-5, atol=1e-5)


def test_plain_k7_padding_semantics():
    # the reference's own case (tests/test_sddmm.py:42)
    rng = np.random.default_rng(42)
    x = rng.normal(size=(20, 8)).astype(np.float32)
    src = np.array([0, 5, 99], np.int32)
    dst = np.array([1, 6, 2], np.int32)
    want = np.asarray(jsd.sddmm_pallas(*map(jnp.asarray, (x, x, src, dst)),
                                       chunk=8, interpret=True))
    got = tsd.sddmm_kernel(*map(_t, (x, x, src, dst))).numpy()
    assert got[2] == 0.0 == want[2]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0], x[0] @ x[1], rtol=1e-5)


def test_k7_node_cap():
    x = np.zeros((jsd.MAX_PALLAS_NODES, 4), np.float32)
    ids = np.zeros(3, np.int32)
    with pytest.raises(ValueError):
        jsd.sddmm_pallas(*map(jnp.asarray, (x, x, ids, ids)), interpret=True)
    with pytest.raises(ValueError, match="cap"):
        tsd.sddmm_kernel(*map(_t, (x, x, ids, ids)))
    assert tsd.MAX_PALLAS_NODES == jsd.MAX_PALLAS_NODES
    ok = tsd.sddmm_kernel(*map(_t, (x[:-1], x[:-1], ids, ids)))  # N = 8191
    assert ok.shape == (3,)


def test_k7_is_forward_only_like_the_reference():
    rng = np.random.default_rng(1)
    x, y, src, dst = _case(rng, 30, 8, 50)
    # the reference kernel has no VJP: jax.grad through it fails
    with pytest.raises(Exception, match="[Ll]inearization"):
        jax.grad(lambda a: jnp.sum(jsd.sddmm_pallas(
            a, jnp.asarray(y), jnp.asarray(src), jnp.asarray(dst),
            interpret=True)))(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward only"):
        tsd.sddmm_kernel(tx, _t(y), _t(src), _t(dst))
    with torch.no_grad():
        assert tsd.sddmm_kernel(tx, _t(y), _t(src), _t(dst)).shape == (50,)


def test_k7_checks_its_shapes():
    x = torch.zeros((10, 4))
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tsd.sddmm_kernel(x, x[:, :3], ids, ids)
    with pytest.raises(ValueError):
        tsd.sddmm_kernel(x, x, ids, ids[:2])


@pytest.mark.parametrize("n,d,e", [(50, 16, 200), (130, 128, 700)])
def test_sddmm_xla_matches_jax(n, d, e):
    rng = np.random.default_rng(e)
    x, y, src, dst = _case(rng, n, d, e)
    src[0], dst[1] = n + 3, -1
    want = np.asarray(jsd.sddmm_xla(*map(jnp.asarray, (x, y, src, dst))))
    got = tsd.sddmm_xla(*map(_t, (x, y, src, dst))).numpy()
    assert _rel(got, want) <= 1e-5
    assert got[0] == 0 == got[1]


def test_sddmm_relational_xla_matches_jax():
    rng = np.random.default_rng(7)
    n, d, e, r = 40, 8, 100, 5
    x, y, src, dst = _case(rng, n, d, e)
    w = rng.normal(size=(r, d, d)).astype(np.float32)
    rel = rng.integers(0, r, e).astype(np.int32)
    rel[:4] = [r, -1, r + 3, 0]  # out of range: score 0
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsd.sddmm_relational_xla(
            *map(jnp.asarray, (x, y, w, src, dst, rel)), r))
    got = tsd.sddmm_relational_xla(*map(_t, (x, y, w, src, dst, rel)),
                                   r).numpy()
    assert _rel(got, want) <= 1e-5
    assert (got[:3] == 0).all()


def test_k7_over_a_sparse_batch_matches_pallas_interpret():
    """The final-layer node embeddings of a flattened batch, scored over
    the batch's own edges (the card check's shape (ii), small)."""
    from mpqe_tpu_torch.data.batcher import (DenseQueryBatch,
                                             dense_to_sparse,
                                             template_edge_norm)
    from mpqe_tpu_torch.models import mpqe as tm
    from mpqe_tpu_torch.models import embeddings as temb
    from mpqe_tpu_torch.ops import rgcn as trgcn
    from mpqe_tpu_torch.queries import STRUCTURES

    cfg = tm.MPQEConfig(n_entities=60, n_modes=3, n_rels=8, embed_dim=16,
                        n_layers=2, num_bases=2)
    model = tm.init_mpqe(torch.Generator().manual_seed(0), cfg)
    spec = STRUCTURES["3-inter_chain"]
    rng = np.random.default_rng(3)
    B = 16
    rels = rng.integers(0, 8, spec.n_edges).astype(np.int32)
    b = DenseQueryBatch(
        "3-inter_chain", B,
        rng.integers(0, 60, (B, spec.n_nodes)).astype(np.int32),
        rng.integers(0, 3, (B, spec.n_nodes)).astype(np.int32), rels,
        template_edge_norm(spec, rels), np.zeros(B, np.int32),
        np.zeros((B, 1), np.int32), np.ones((B, 1), np.float32),
        np.ones(B, np.float32))
    sb = dense_to_sparse(b, 8)
    e = sb.edges
    with torch.no_grad():
        x = temb.embed_nodes_sparse(model.emb, _t(sb.node_entity),
                                    _t(sb.node_mode), _t(sb.node_is_var))
        for lp in model.layers:
            x = trgcn.rgcn_sparse(x, lp, _t(e.src), _t(e.dst), _t(e.rel),
                                  _t(e.norm), 8, segment_backend="pallas")
        got = tsd.sddmm_kernel(x, x, _t(e.src), _t(e.dst)).numpy()
    xn = x.numpy()
    want = np.asarray(jsd.sddmm_pallas(
        *map(jnp.asarray, (xn, xn, e.src, e.dst)), interpret=True))
    assert got.shape == (e.capacity,)
    assert _rel(got, want) <= 1e-5


def _numpy_k7_order(x, y, src, dst):
    """The sum order ``csrc/sddmm.cu`` documents, in numpy float32: lane
    g of 8 adds the products at k = 32 j + 4 g + v (j, then v ascending;
    +0 past d), then the butterfly m = 4, 2, 1."""
    n, d = x.shape
    E = src.shape[0]
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    xs = x[np.where(ok, src, 0)].astype(np.float32)
    ys = y[np.where(ok, dst, 0)].astype(np.float32)
    lanes = [np.zeros(E, np.float32) for _ in range(8)]
    for j in range(-(-d // 32)):
        for g in range(8):
            for v in range(4):
                k = 32 * j + 4 * g + v
                p = (xs[:, k] * ys[:, k] if k < d
                     else np.zeros(E, np.float32))
                lanes[g] = (lanes[g] + p).astype(np.float32)
    m = 4
    while m:
        lanes = [(lanes[g] + lanes[g + m]).astype(np.float32)
                 for g in range(m)]
        m //= 2
    return np.where(ok, lanes[0], np.float32(0))


@pytest.mark.parametrize("n,d,e", [(40, 1, 300), (40, 5, 300),
                                   (64, 37, 500), (130, 128, 700),
                                   (20, 200, 90), (16, 64, 0)])
def test_plain_k7_follows_the_documented_sum_order(n, d, e):
    rng = np.random.default_rng(d * 7 + e)
    x, y, src, dst = _case(rng, n, d, e)
    if e:
        src[:2] = [-1, n]
        dst[2] = n + 4
    want = _numpy_k7_order(x, y, src, dst)
    got = tsd.sddmm_reference(*map(_t, (x, y, src, dst))).numpy()
    assert got.dtype == np.float32 and got.shape == (e,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        tsd.sddmm_kernel(*map(_t, (x, y, src, dst))).numpy(), got)
