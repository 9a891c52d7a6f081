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

The kernels' per-relation route (``ring_route``, ``rgcn_ring_halo_route``)
runs here in plain PyTorch: its layouts against a numpy recount, its
out-of-range rules against the TPU kernel's semantics (1e-5), and its
products emulated in the kernel's split-TF32 order
(``tools/k5_probe.py emulated_messages``) within ``ring_gate`` (K5's
gates: 1e-4 of the plain version, 1e-5 of the f32 oracles), while one
TF32 pass and both negative controls fail it.
"""

import functools

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
from mpqe_tpu_torch.tools import k5_probe

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


def _odd(pr, seed, share=0.15):
    """``pr``'s arrays with ids the partitioners never make."""
    rng = np.random.default_rng(seed)
    src, dst, rel = (a.copy() for a in (pr.src_local, pr.dst_local, pr.rel))
    real = dst < pr.block_size
    pick = lambda: rng.random(src.shape) < share  # noqa: E731
    src[real & pick()] = pr.block_size + 3
    src[real & pick()] = -2
    rel[real & pick()] = -1
    rel[real & pick()] = N_RELS + 1
    dst[real & pick()] = -5
    return thalo.RingPartitionedEdges(
        src_local=src, dst_local=dst, rel=rel, norm=pr.norm,
        n_parts=pr.n_parts, block_size=pr.block_size, n_nodes=pr.n_nodes,
        n_rels=N_RELS)


@pytest.mark.parametrize("chunk", [4, 32])
@pytest.mark.parametrize("n_parts", [2, 3])
def test_k8_route_layouts_match_a_numpy_recount(n_parts, chunk):
    # per hop and part: the edges whose dst lies in the block, in relation
    # chunks (rel out of range: slot N_RELS, a zero W), each relation's
    # run in bucket order and padded to whole chunks, the first live[s]
    # chunks real; src out of range reads the zero row after both slots;
    # the destination order stable in bucket order, as message rows
    _, pr, _ = _ring_case(20 + n_parts, n_parts, 12 * n_parts,
                          50 * n_parts)
    odd = _odd(pr, n_parts)
    P, block = n_parts, pr.block_size
    L = P  # every part on one device
    parts = torch.arange(P, dtype=torch.int32)
    rt = tring.ring_route(*_edges(odd), parts, P, block, N_RELS, chunk)
    e_max = odd.src_local.shape[-1]
    assert rt.chunk == chunk
    assert rt.n_chunks == L * (-(-e_max // chunk) + min(N_RELS + 1, e_max))
    zero_row = 2 * L * block
    for s in range(P):
        base, n_live = 0, 0
        for i in range(L):
            b = (i - s) % P
            src, dst = odd.src_local[i, b], odd.dst_local[i, b]
            rel, norm = odd.rel[i, b], odd.norm[i, b]
            keep = [e for e in range(e_max) if 0 <= dst[e] < block]
            slot = {e: (rel[e] if 0 <= rel[e] < N_RELS else N_RELS)
                    for e in keep}
            row_of = {}
            for r in sorted(set(slot.values())):
                run = [e for e in keep if slot[e] == r]
                for k, e in enumerate(run):
                    row_of[e] = (base + k // chunk) * chunk + k % chunk
                n_ch = -(-len(run) // chunk)
                assert (rt.crel[s, base:base + n_ch] == r).all()
                base += n_ch
                n_live += n_ch
            for e, row in row_of.items():
                want = ((s % 2) * L + i) * block + src[e] \
                    if 0 <= src[e] < block else zero_row
                assert int(rt.src[s, row]) == want
                assert float(rt.norm[s, row]) == float(norm[e])
            order = sorted(keep, key=lambda e: (dst[e], e))
            got = rt.drow[s, i, :len(order)].tolist()
            assert got == [row_of[e] for e in order]
            offs = [sum(1 for e in keep if dst[e] < r)
                    for r in range(block + 1)]
            assert rt.doffs[s, i].tolist() == offs
        assert int(rt.live[s]) == n_live
        assert (rt.crel[s, n_live:] == N_RELS).all()


def test_k8_route_chunk_follows_the_bucket_size():
    assert tring.route_chunk(128 * 267, 266) == 128
    assert tring.route_chunk(128 * 267 - 1, 266) == 32


@pytest.mark.parametrize("n_parts", [2, 3])
def test_k8_route_odd_ids_follow_the_tpu_kernel(n_parts):
    # the route's out-of-range rules give the TPU kernel's semantics (the
    # float64 oracle), its products plain f32 (K5's k-ascending order)
    _, pr, x = _ring_case(30 + n_parts, n_parts, 12 * n_parts, 60 * n_parts)
    odd = _odd(pr, 40 + n_parts)
    _, layer = _layer(2, n_parts)
    with torch.no_grad():
        got = tring.rgcn_ring_halo_route(_cpu_ring(n_parts), layer, _t(x),
                                         *_edges(odd), N_RELS)
    assert _rel(got.numpy(), _k8_oracle(layer, x, odd, N_RELS)) <= TOL


@pytest.mark.parametrize("n_parts", [2, 3, 4])
@pytest.mark.parametrize("d", [16, 128])
def test_k8_route_in_split_tf32_meets_ring_gate(d, n_parts):
    # the kernels' route with its products emulated in the kernel's order
    # (split TF32, tools/k5_probe.py) within ring_gate of the plain
    # version and of both f32 oracles; one TF32 pass fails it, and so does
    # the plain version with one edge's rel changed or its src moved
    rng = np.random.default_rng(d + n_parts)
    n, e = 16 * n_parts * 3, 80 * n_parts * 3
    st = tes.build_edge_store(rng.integers(0, n, e), rng.integers(0, n, e),
                              rng.integers(0, N_RELS, e), n, N_RELS)
    pr = thalo.partition_edges_ring(st, n_parts)
    layer = trgcn.init_rgcn_layer(torch.Generator().manual_seed(d), d, d,
                                  N_RELS, 3)
    x = _t(rng.normal(size=(pr.n_nodes_padded, d)).astype(np.float32))
    m, edges = _cpu_ring(n_parts), _edges(pr)
    threads = torch.get_num_threads()
    # the emulation's many small float64 products on one thread: beside
    # other test workers, a thread pool each spins far longer than it works
    torch.set_num_threads(1)
    try:
        _route_gate_case(st, pr, layer, x, m, edges)
    finally:
        torch.set_num_threads(threads)


def _route_gate_case(st, pr, layer, x, m, edges):
    with torch.no_grad():
        plain = tring.rgcn_ring_halo_rdma_reference(m, layer, x, *edges,
                                                    N_RELS)
        ring = thalo.rgcn_ring_halo(m, layer, x, *edges, N_RELS)
        single = trgcn.rgcn_sparse(x[:st.n_nodes], layer, _t(st.src),
                                   _t(st.dst), _t(st.rel), _t(st.norm),
                                   N_RELS)
        got = {passes: tring.rgcn_ring_halo_route(
            m, layer, x, *edges, N_RELS, messages=functools.partial(
                k5_probe.emulated_messages, passes=passes))
            for passes in (3, 1)}
        controls = [tring.rgcn_ring_halo_rdma_reference(m, layer, x, *c,
                                                        N_RELS)
                    for c in tring.ring_controls(edges, N_RELS,
                                                 pr.block_size)]

    def gate(y):
        return tring.ring_gate(y, plain, [(y, ring), (y[:st.n_nodes],
                                                      single)])

    g3 = gate(got[3])
    assert g3["ok"], g3
    assert g3["err_vs_plain"] <= 3e-6, g3  # the card's K5 figures: ~2e-6
    assert not gate(got[1])["ok"]
    for c in controls:
        assert not tring.ring_gate(got[3], c)["ok"]
