"""K8 in the PyTorch port (``mpqe_tpu_torch/ops/ring.py``: the plain
version that the wrapper runs for CPU tensors) against the JAX package's
Pallas kernel ``rgcn_ring_halo_rdma`` in interpret mode on the
conftest's virtual CPU mesh, against the port's own ``rgcn_ring_halo``
and ``rgcn_sparse`` at every ring size the reference tests (2, 3, 4, 8:
each pairs its ack tokens differently), and its refusals.

A ring of P parts here is ``make_mesh((P, 1), devices=["cpu"] * P)``:
each part has its own double buffer and receives its neighbour's block
only by a copy, as on one card.  Tolerance (max|diff| / max|ref|): f32
on both sides, only the order of the sums differs: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.ops import pallas_ring as jring
from mpqe_tpu.ops import rgcn as jrgcn
from mpqe_tpu_torch.convert import layer_from_numpy
from mpqe_tpu_torch.ops import edge_store as tes
from mpqe_tpu_torch.ops import rgcn as trgcn
from mpqe_tpu_torch.ops import ring as tring
from mpqe_tpu_torch.parallel import halo as thalo
from mpqe_tpu_torch.parallel import mesh as tmesh

D, N_RELS = 16, 6
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(nb, seed):
    params = jrgcn.init_rgcn_layer(jax.random.PRNGKey(seed), D, D, N_RELS,
                                   nb)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["bias"] = (0.1 * np.random.default_rng(seed).normal(
        size=params["bias"].shape)).astype(np.float32)
    return params, layer_from_numpy(params, "cpu")


def _ring_case(seed, n_parts, n_nodes, n_e):
    """(edge store, ring partition, padded x) of a random graph."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, n_nodes, n_e).astype(np.int32),
         rng.integers(0, n_nodes, n_e).astype(np.int32),
         rng.integers(0, N_RELS, n_e).astype(np.int32))
    st = tes.build_edge_store(*a, n_nodes, N_RELS)
    pr = thalo.partition_edges_ring(st, n_parts)
    x = rng.normal(size=(pr.n_nodes_padded, D)).astype(np.float32)
    return st, pr, x


def _cpu_ring(n_parts):
    return tmesh.make_mesh((n_parts, 1), devices=["cpu"] * n_parts)


def _edges(pr):
    return [_t(a) for a in (pr.src_local, pr.dst_local, pr.rel, pr.norm)]


def test_plain_k8_matches_pallas_interpret():
    from jax.sharding import Mesh

    _, pr, x = _ring_case(1, 4, 48, 200)
    params, layer = _layer(3, 0)
    jmesh4 = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    want = np.asarray(jring.rgcn_ring_halo_rdma(
        jmesh4, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x), jnp.asarray(pr.src_local), jnp.asarray(pr.dst_local),
        jnp.asarray(pr.rel), jnp.asarray(pr.norm), N_RELS, interpret=True))
    with torch.no_grad():
        got = tring.rgcn_ring_halo_rdma(_cpu_ring(4), layer, _t(x),
                                        *_edges(pr), N_RELS)
    assert got.shape == (pr.n_nodes_padded, D)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("n_parts", [2, 3, 4, 8])
def test_plain_k8_matches_ring_halo_and_sparse(n_parts):
    # every ring size pairs its ack tokens (hops 0..P-3 post, 1..P-2
    # consume) differently; P = 2 has none
    st, pr, x = _ring_case(10 + n_parts, n_parts, 16 * n_parts,
                           60 * n_parts)
    _, layer = _layer(3, n_parts)
    m = _cpu_ring(n_parts)
    n = st.n_nodes
    with torch.no_grad():
        got = tring.rgcn_ring_halo_rdma(m, layer, _t(x), *_edges(pr), N_RELS)
        ring = thalo.rgcn_ring_halo(m, layer, _t(x), *_edges(pr), N_RELS)
        single = trgcn.rgcn_sparse(_t(x[:n]), layer, _t(st.src), _t(st.dst),
                                   _t(st.rel), _t(st.norm), N_RELS)
        plain = tring.rgcn_ring_halo_rdma_reference(m, layer, _t(x),
                                                    *_edges(pr), N_RELS)
    assert _rel(got.numpy(), ring.numpy()) <= TOL
    assert _rel(got[:n].numpy(), single.numpy()) <= TOL
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert tring.rgcn_ring_halo_rdma.launches == 0  # no kernel on the CPU


def _k8_oracle(layer, x, pr, n_rels):
    """The TPU kernel's semantics in float64, edge by edge: a zero row for
    an out-of-range src, a zero coefficient for a rel outside [0, n_rels),
    an out-of-range dst dropped."""
    P, block = pr.n_parts, pr.block_size
    basis = layer.basis.detach().double().numpy()
    coeff = layer.coeff.detach().double().numpy()
    xd = x.astype(np.float64)
    agg = np.zeros((P * block, basis.shape[2]))
    for p in range(P):
        for b in range(P):
            for e in range(pr.src_local.shape[-1]):
                s, d = pr.src_local[p, b, e], pr.dst_local[p, b, e]
                r, w = pr.rel[p, b, e], pr.norm[p, b, e]
                if not 0 <= d < block:
                    continue
                xs = xd[b * block + s] if 0 <= s < block else 0 * xd[0]
                c = coeff[r] if 0 <= r < n_rels else 0 * coeff[0]
                msg = sum(c[k] * (xs @ basis[k]) for k in range(len(c)))
                agg[p * block + d] += msg * w
    return (xd @ layer.w_self.detach().double().numpy() + agg
            + layer.bias.detach().double().numpy())


def test_plain_k8_odd_ids_follow_the_tpu_kernel():
    # ids the partitioners never make: the TPU kernel's one-hots give a
    # zero row for src outside the block, a zero coefficient for rel
    # outside [0, n_rels) (negative too, where the XLA ring clamps to
    # relation 0), and drop dst outside the block
    _, pr, x = _ring_case(3, 2, 24, 80)
    _, layer = _layer(2, 3)
    rng = np.random.default_rng(3)
    src, dst, rel = (a.copy() for a in (pr.src_local, pr.dst_local, pr.rel))
    real = dst < pr.block_size
    pick = lambda: rng.random(src.shape) < 0.15  # noqa: E731
    src[real & pick()] = pr.block_size + 3
    src[real & pick()] = -2
    rel[real & pick()] = -1
    rel[real & pick()] = N_RELS + 1
    dst[real & pick()] = -5
    odd = thalo.RingPartitionedEdges(
        src_local=src, dst_local=dst, rel=rel, norm=pr.norm, n_parts=2,
        block_size=pr.block_size, n_nodes=pr.n_nodes, n_rels=N_RELS)
    with torch.no_grad():
        got = tring.rgcn_ring_halo_rdma(_cpu_ring(2), layer, _t(x),
                                        *_edges(odd), N_RELS)
    assert _rel(got.numpy(), _k8_oracle(layer, x, odd, N_RELS)) <= TOL


def test_ring_layout_orders_each_bucket_by_destination():
    dst = torch.tensor([[[3, 1, 4, 1, 5, 9, 2, 6]]], dtype=torch.int32)
    perm, offs = tring.ring_layout(dst, 5)
    assert perm.dtype == offs.dtype == torch.int32
    # rows 1, 1, 2, 3, 4 in bucket order, then 5, 9, 6 (out of range)
    assert perm[0, 0].tolist() == [1, 3, 6, 0, 2, 4, 5, 7]
    assert offs[0, 0].tolist() == [0, 0, 2, 3, 4, 5]


def test_k8_refusals():
    _, pr, x = _ring_case(4, 2, 16, 40)
    m = _cpu_ring(2)
    _, full = _layer(None, 4)
    with pytest.raises(ValueError, match="basis decomposition"):
        with torch.no_grad():
            tring.rgcn_ring_halo_rdma(m, full, _t(x), *_edges(pr), N_RELS)
    _, layer = _layer(3, 4)
    with pytest.raises(NotImplementedError, match="forward only"):
        tring.rgcn_ring_halo_rdma(m, layer, _t(x), *_edges(pr), N_RELS)
    with torch.no_grad():
        with pytest.raises(ValueError, match="float32"):
            tring.rgcn_ring_halo_rdma(m, layer, _t(x).double(), *_edges(pr),
                                      N_RELS)
        with pytest.raises(ValueError, match=r"\[2, 2, e_max\]"):
            tring.rgcn_ring_halo_rdma(m, layer, _t(x),
                                      *(e[:1] for e in _edges(pr)), N_RELS)
        with pytest.raises(ValueError, match="integers"):
            e = _edges(pr)
            tring.rgcn_ring_halo_rdma(m, layer, _t(x), e[0].float(), *e[1:],
                                      N_RELS)
