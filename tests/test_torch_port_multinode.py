"""The parallel layer over several nodes, on the CPU under gloo: which
node each process is on (``parallel/multihost.py nodes``: the host name
and torchrun's ``GROUP_RANK``), the transport chosen from the nodes,
the refusals of CUDA IPC between nodes, and K8's plain route and the
halo step with their processes on two nodes, held to one process and to
the JAX package.

This file is also the worker: ``python <this file> <mode> <port> <rank>
<world> <case.npz> <out.npz>`` joins a ``gloo`` group of ``world``
processes at ``127.0.0.1:<port>`` (the test sets ``GROUP_RANK`` per
process, as ``torchrun --nnodes 2 --node_rank i`` does):

* every mode reports ``multihost.nodes()``;
* ``k8`` (2 processes, nodes 0 and 1; or 4 processes, nodes 0, 0, 1, 1)
  runs K8's plain route (``rgcn_ring_halo_rdma`` on CPU tensors) at each
  ring size of ``<case.npz>`` with the parts spread over the processes,
  each boundary block crossing by a gloo send and receive, the pairing
  K8 runs by NCCL between nodes on the card; rank 0 also runs it in one
  process; then an exchange of CPU tensors with unequal counts, and a
  CUDA exchange, which a gloo group over several nodes refuses;
* with 4 processes it also runs 3 halo steps (``halo_ring``,
  ``halo_gather``) from the JAX package's initial parameters over an
  (8, 1) mesh, two parts a process (2 nodes x 2 processes x 2 parts),
  and rank 0 the same on one process's (8, 1) mesh.

Tolerances: K8's plain route over two nodes bit-equal to one process,
and within 1e-5 (max|diff| / max|ref|) of the JAX package's
``rgcn_ring_halo`` on the same numpy inputs; the halo step's losses over
two nodes within 1e-6 (relative) of one process (the parameters'
gradients are summed over processes in another order) and within 1e-5
of the JAX package's 8-device halo step (the reference's own
tolerance).  ``communicate(timeout=300)`` kills every worker on a hang.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
KINDS = ("ring", "gather")
D, N_RELS = 16, 6
# (processes, their nodes) -> the ring sizes they run: one and two parts
# a process
GROUPS = {"2x1": ((0, 1), (2, 4)), "2x2": ((0, 0, 1, 1), (4, 8))}
RING_SIZES = (2, 4, 8)


# ---------------------------------------------------------------- worker
def _halo_losses(named, mesh, kind):
    """3 halo steps under the reference's Adam config from the parameters
    ``named`` (tests/_multihost_common.py's model and batches)."""
    import _multihost_common as C
    import torch

    from mpqe_tpu_torch.models import mpqe as tm
    from mpqe_tpu_torch.parallel import halo_train as tht
    from mpqe_tpu_torch.train import loop as tloop

    cfg = tm.MPQEConfig(n_entities=C.N_ENT, n_modes=C.N_MODES,
                        n_rels=C.N_RELS, embed_dim=C.D,
                        n_layers=C.N_LAYERS, num_bases=C.BASES,
                        readout="tgt")
    tc = tloop.TrainConfig(lr=0.01, batch_size=C.B, n_neg=C.N_NEG)
    model = tm.MPQE(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in named.items()})
    opt = tloop.make_optimizer(tc, model.parameters())
    step = tht.make_halo_train_step(cfg, opt, mesh, kind)
    return np.asarray([float(step(model, C.STRUCT, *[
        torch.from_numpy(g[k]) for k in C.BATCH_ORDER]))
        for g in C.global_batches()])


def _k8(case, P, mesh):
    import torch

    from mpqe_tpu_torch.convert import layer_from_numpy
    from mpqe_tpu_torch.ops import ring

    layer = layer_from_numpy({k: case[f"{P}/layer/{k}"] for k in (
        "w_self", "bias", "basis", "coeff")}, "cpu")
    t = [torch.from_numpy(case[f"{P}/{k}"])
         for k in ("x", "src", "dst", "rel", "norm")]
    with torch.no_grad():
        return ring.rgcn_ring_halo_rdma(mesh, layer, *t, N_RELS).numpy()


def _worker(argv):
    mode, port, rank, world = argv[0], argv[1], int(argv[2]), int(argv[3])
    case_npz, out = argv[4], argv[5]
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import torch

    from mpqe_tpu_torch.parallel import mesh as tmesh
    from mpqe_tpu_torch.parallel import multihost

    assert multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                device="cpu", timeout_s=120)
    res = {"nodes": np.asarray(multihost.nodes()),
           "transport": np.asarray(multihost.transport("cpu"))}
    if mode == "k8":
        with np.load(case_npz) as z:
            case = {k: z[k] for k in z.files}
        for P in RING_SIZES:
            if f"{P}/x" not in case or P % world:
                continue
            res[f"k8/{P}"] = _k8(case, P, multihost.global_mesh(
                (P, 1), ["cpu"] * (P // world)))
            if rank == 0:
                res[f"k8_one/{P}"] = _k8(case, P, tmesh.make_mesh(
                    (P, 1), devices=["cpu"] * P))
        got = multihost.exchange(
            [torch.full((2, 3), float(rank))] * (rank + 1), "cpu", "nodes")
        res["exchange"] = np.asarray([[len(g)] + [float(t[0, 0]) for t in g]
                                      + [-1.0] * (world - len(g))
                                      for g in got])
        try:
            multihost.exchange([], "cuda:0", "refused")
            res["cuda_refused"] = np.asarray("")
        except ValueError as e:
            res["cuda_refused"] = np.asarray(str(e))
        if world == 4:
            named = {k[len("init/"):]: v for k, v in case.items()
                     if k.startswith("init/")}
            two = multihost.global_mesh((8, 1), ["cpu"] * 2)
            for kind in KINDS:
                res[f"halo/{kind}"] = _halo_losses(named, two, kind)
                if rank == 0:
                    res[f"halo_one/{kind}"] = _halo_losses(
                        named, tmesh.make_mesh((8, 1), devices=["cpu"] * 8),
                        kind)
    np.savez(out, **res)


# ----------------------------------------------------------------- tests
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp, label, mode, group_ranks, case_npz):
    """The workers of one group, ``GROUP_RANK`` set per process (None:
    unset); returns (the processes, their output paths)."""
    port = _free_port()
    procs, outs = [], []
    for r, g in enumerate(group_ranks):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.pop("GROUP_RANK", None)
        if g is not None:
            env["GROUP_RANK"] = str(g)
        outs.append(str(tmp / f"{label}_rank{r}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, mode, str(port), str(r),
             str(len(group_ranks)), case_npz, outs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True))
    return procs, outs


def _jax_case(path):
    """K8's inputs at each RING_SIZES (a random graph, a JAX layer with a
    random bias) with the JAX package's ``rgcn_ring_halo`` on them, and
    the JAX package's halo steps under the reference's Adam config from
    ``init_halo_train_state(PRNGKey(0))`` (whose parameters the case
    carries): writes ``path``, returns the JAX outputs by key."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import _multihost_common as C
    from mpqe_tpu.ops import rgcn as jrgcn
    from mpqe_tpu.parallel import halo as jhalo
    from mpqe_tpu.parallel import halo_train as jht
    from mpqe_tpu.parallel import mesh as jmesh
    from mpqe_tpu_torch.ops import edge_store as tes
    from mpqe_tpu_torch.parallel import halo as thalo

    case, want = {}, {}
    for P in RING_SIZES:
        rng = np.random.default_rng(30 + P)
        n_nodes, n_e = 12 * P, 50 * P
        st = tes.build_edge_store(
            rng.integers(0, n_nodes, n_e).astype(np.int32),
            rng.integers(0, n_nodes, n_e).astype(np.int32),
            rng.integers(0, N_RELS, n_e).astype(np.int32), n_nodes, N_RELS)
        pr = thalo.partition_edges_ring(st, P)
        x = rng.normal(size=(pr.n_nodes_padded, D)).astype(np.float32)
        params = {k: np.asarray(v) for k, v in jrgcn.init_rgcn_layer(
            jax.random.PRNGKey(P), D, D, N_RELS, 3).items()}
        params["bias"] = (0.1 * rng.normal(size=params["bias"].shape)
                          ).astype(np.float32)
        for k, v in params.items():
            case[f"{P}/layer/{k}"] = v
        for k, v in (("x", x), ("src", pr.src_local), ("dst", pr.dst_local),
                     ("rel", pr.rel), ("norm", pr.norm)):
            case[f"{P}/{k}"] = np.asarray(v)
        jm = Mesh(np.asarray(jax.devices()[:P]), ("data",))
        want[f"k8/{P}"] = np.asarray(jhalo.rgcn_ring_halo(
            jm, {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(x), *(jnp.asarray(a) for a in (
                pr.src_local, pr.dst_local, pr.rel, pr.norm)), N_RELS))

    def named(p):
        out = {"emb.ent": p["emb"]["ent"], "emb.var": p["emb"]["var"]}
        for i, lp in enumerate(p["layers"]):
            out.update({f"layers.{i}.{k}": v for k, v in lp.items()})
        for k, v in p.get("readout", {}).items():
            out[f"readout.{k}"] = v
        return {k: np.asarray(v) for k, v in out.items()}

    cfg, tc = C.model_config(), C.train_config()
    mesh = jmesh.make_mesh((8, 1), devices=jax.devices()[:8])
    rep = NamedSharding(mesh, PartitionSpec())
    with jax.default_matmul_precision("highest"):
        for kind in KINDS:
            state = jht.init_halo_train_state(jax.random.PRNGKey(0), cfg, tc,
                                              mesh)
            for k, v in named(state.params).items():
                case[f"init/{k}"] = v
            step = jht.make_halo_train_step(cfg, tc, mesh, layer_kind=kind)
            p, o, losses = state.params, state.opt_state, []
            for g in C.global_batches():
                arrs = {k: jax.device_put(np.asarray(v), rep)
                        for k, v in g.items()}
                p, o, loss = step(p, o, C.STRUCT,
                                  *[arrs[k] for k in C.BATCH_ORDER])
                losses.append(float(loss))
            want[f"halo/{kind}"] = np.asarray(losses)
    np.savez(path, **case)
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One host without ``GROUP_RANK`` (2 processes), then the JAX
    oracles, then 2 nodes x 1 process and 2 nodes x 2 processes."""
    sys.path.insert(0, HERE)
    tmp = tmp_path_factory.mktemp("multinode")
    started = [("one", *_launch(tmp, "one", "nodes", (None, None), "-"))]
    case_npz = str(tmp / "case.npz")
    jax_out = _jax_case(case_npz)
    for label, (nodes, _) in GROUPS.items():
        started.append((label, *_launch(tmp, label, "k8", nodes, case_npz)))
    got, t0 = {}, time.perf_counter()
    for label, procs, outs in started:
        for p in procs:
            try:
                _, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for _, qs, _ in started:
                    for q in qs:
                        q.kill()
                raise
            assert p.returncode == 0, f"{label} worker failed:\n{err[-3000:]}"
        got[label] = []
        for o in outs:
            with np.load(o) as z:
                got[label].append({k: z[k] for k in z.files})
    got["seconds"] = time.perf_counter() - t0
    return got, jax_out


@pytest.mark.parametrize("label", list(GROUPS))
def test_nodes_follow_group_rank(runs, label):
    """Processes started with ``GROUP_RANK`` 0, 1 (or 0, 0, 1, 1) on one
    host report nodes [0, 1] ([0, 0, 1, 1]) in every process."""
    got, _ = runs
    for w in got[label]:
        assert w["nodes"].tolist() == list(GROUPS[label][0])


def test_one_host_without_group_rank_is_one_node(runs):
    got, _ = runs
    for w in got["one"]:
        assert w["nodes"].tolist() == [0, 0]
        assert str(w["transport"]) == "gloo"


@pytest.mark.parametrize("label", list(GROUPS))
def test_gloo_group_over_nodes_refuses_cuda_tensors(runs, label):
    """A gloo group over several nodes handed CUDA tensors raises
    ``ValueError`` naming NCCL before any collective (no backend is
    switched to, nothing staged through the host)."""
    got, _ = runs
    for w in got[label]:
        msg = str(w["cuda_refused"])
        assert "NCCL" in msg and "gloo" in msg, msg


@pytest.mark.parametrize("label", list(GROUPS))
def test_exchange_over_two_nodes_on_the_cpu(runs, label):
    """CPU tensors, unequal counts (rank r sends r + 1), every process
    receiving every process's in process order."""
    got, _ = runs
    world = len(GROUPS[label][0])
    for w in got[label]:
        table = w["exchange"]
        for r in range(world):
            assert int(table[r, 0]) == r + 1
            assert table[r, 1:r + 2].tolist() == [float(r)] * (r + 1)


def _k8_cases():
    return [(label, P) for label, (_, sizes) in GROUPS.items()
            for P in sizes]


@pytest.mark.parametrize("label,P", _k8_cases())
def test_plain_k8_over_two_nodes_bit_equal_one_process(runs, label, P):
    """K8's plain route with its boundary blocks crossing by a gloo send
    and receive (one, two parts a process) equals the one-process plain
    route bit for bit, in every process."""
    got, _ = runs
    want = got[label][0][f"k8_one/{P}"]
    assert np.abs(want).max() > 0
    for w in got[label]:
        np.testing.assert_array_equal(w[f"k8/{P}"], want)


@pytest.mark.parametrize("label,P", _k8_cases())
def test_plain_k8_over_two_nodes_matches_jax_ring_halo(runs, label, P):
    got, jax_out = runs
    a, b = got[label][0][f"k8/{P}"], jax_out[f"k8/{P}"]
    assert a.shape == b.shape
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_halo_step_over_two_nodes_matches_one_process(runs, kind):
    """2 nodes x 2 processes x 2 parts: every rank's losses equal, and
    within 1e-6 (relative) of one process's (8, 1) mesh."""
    got, _ = runs
    ws = got["2x2"]
    want = ws[0][f"halo_one/{kind}"]
    assert len(want) == 3 and np.isfinite(want).all()
    for w in ws:
        np.testing.assert_array_equal(w[f"halo/{kind}"], ws[0][f"halo/{kind}"])
    np.testing.assert_allclose(ws[0][f"halo/{kind}"], want, rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_halo_step_over_two_nodes_matches_jax(runs, kind):
    """The reference's oracle and tolerance: its 8-device single-process
    halo step under its Adam config."""
    got, jax_out = runs
    np.testing.assert_allclose(got["2x2"][0][f"halo/{kind}"],
                               jax_out[f"halo/{kind}"], rtol=1e-5, atol=0)


# --------------------------------------------- the choice, in one process
@pytest.mark.parametrize("nodes,device,nccl,want", [
    ([0], "cpu", False, "gloo"),
    ([0, 1], "cpu", True, "gloo"),
    ([0, 0], "cuda:0", False, "ipc"),
    ([0, 0, 0, 0], "cuda:1", True, "ipc"),
    ([0, 1], "cuda:0", True, "nccl"),
    ([0, 0, 1, 1], "cuda:0", True, "nccl"),
    ([0, 1], "cuda:0", False, ValueError),
    ([0], "meta", True, ValueError),
])
def test_transport_follows_the_nodes(monkeypatch, nodes, device, nccl, want):
    """``multihost.transport`` as a function of the nodes and of whether
    the group has NCCL (emulated: no group is made here)."""
    import torch.distributed as dist

    from mpqe_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "nodes", lambda: nodes)
    monkeypatch.setattr(multihost, "has_nccl", lambda: nccl)
    monkeypatch.setattr(dist, "get_backend",
                        lambda *a: "cpu:gloo,cuda:nccl" if nccl else "gloo")
    if want is ValueError:
        with pytest.raises(ValueError, match="NCCL"):
            multihost.transport(device)
    else:
        assert multihost.transport(device) == want


@pytest.mark.parametrize("nodes,want", [
    ([0, 0], [False, False]),
    ([0, 1], [True, True]),
    ([0, 0, 1, 1], [False, True, False, True]),
    ([0, 1, 1, 1], [True, False, False, True]),
])
def test_k8_boundaries_follow_the_nodes(monkeypatch, nodes, want):
    """Boundary q (process q's last part to process q + 1's first) goes
    by NCCL exactly where the two processes are on different nodes; a
    process sends by NCCL on its own boundary and receives by NCCL on
    its predecessor's."""
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "nodes", lambda: nodes)
    assert ring.boundaries_across(len(nodes)) == want


def test_node_name_and_indices(monkeypatch):
    from mpqe_tpu_torch.parallel import multihost

    monkeypatch.delenv("GROUP_RANK", raising=False)
    host = socket.gethostname()
    assert multihost.node_name() == host
    monkeypatch.setenv("GROUP_RANK", "3")
    assert multihost.node_name() == f"{host}/node3"
    assert multihost.node_indices(["b", "b", "a", "c", "a"]) == [
        0, 0, 1, 2, 1]
    assert multihost.nodes() == [0] and multihost.single_node()


def test_ipc_channel_refuses_a_group_over_nodes(monkeypatch):
    from mpqe_tpu_torch.parallel import ipc, multihost

    monkeypatch.setattr(multihost, "nodes", lambda: [0, 1])
    with pytest.raises(RuntimeError, match="spans nodes"):
        ipc.channel("cuda:0")


def test_ipc_refuses_to_open_memory_of_another_node(monkeypatch):
    """``Shared.mapped`` of a process on another node raises before any
    handle is opened (it would open on one host; between hosts it
    cannot)."""
    from mpqe_tpu_torch.parallel import ipc, multihost

    monkeypatch.setattr(multihost, "nodes", lambda: [0, 1])
    shared = object.__new__(ipc.Shared)
    shared.rank = 0
    shared.infos = [None, (bytes(64), 0, 1, (4,), "float32")]
    opened = dict(ipc._OPENED)
    with pytest.raises(RuntimeError, match="another node"):
        shared.mapped(1, 0)
    assert ipc._OPENED == opened and 1 not in ipc.opened_from()


if __name__ == "__main__":
    _worker(sys.argv[1:])
