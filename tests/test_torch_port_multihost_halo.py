"""The halo layers, the halo train step and K8's plain route with their
parts in two processes (``parallel/multihost.py global_mesh``,
``parallel/mesh.py``'s collectives across processes), on the CPU under
gloo, mirroring the halo half of ``tests/test_multihost.py``.

This file is also the worker: ``python <this file> <port> <rank>
<params.npz> <out.npz>`` joins a two-process ``gloo`` group at
``127.0.0.1:<port>``; its mesh is ``global_mesh((8, 1), ["cpu"] * 4)``,
an 8-part data axis whose parts 0-3 are rank 0's and 4-7 rank 1's, as
the reference's workers make an (8, 1) mesh of 4 virtual devices each.
Each worker runs, and writes to ``<out.npz>``, beside the same in one
process on ``make_mesh((8, 1), ["cpu"] * 8)``:

* 3 halo steps (``halo_ring``, ``halo_gather``) over
  ``tests/_multihost_common.py``'s config and replicated batches, from
  the JAX package's initial parameters, under the reference's Adam
  config and under SGD (the parameters' changes; Adam's step barely
  moves when a gradient is scaled, SGD's is the gradient);
* the SGD ring steps again with an exit whose backward sums the
  processes' cotangents (the negative control);
* each crossing of the parts' boundary (entering parameters, the
  scatter and the exit, ``ppermute``, ``all_gather``, ``psum``) in a
  small function, its output and gradients;
* the four halo layers forward (``rgcn_rel_partitioned`` on a (1, 8)
  mesh, ``rgcn_2d_partitioned`` on (4, 2) and (1, 8), the data-axis
  layers on (8, 1));
* K8's plain route (``rgcn_ring_halo_rdma_reference``) at P = 2, 4, 8
  (one, two, four parts a process), 3 seeds each;
* ``tools/multihost_run.py --parallel halo_ring`` at a small size.

The tests hold the two ranks bit-equal to each other, and to one
process: losses within 1e-6 relative (the sums of the parameters'
gradients over processes are added in another order), SGD changes within
1e-5 absolute, the crossings' outputs bit for bit and their gradients
within 1e-6 relative (the copies' bit for bit), the layers' outputs and
K8's plain route bit for bit; and to the JAX package's single-process 8-device halo step on the
conftest's CPU devices: losses within 1e-5 relative (the reference's own
tolerance), SGD changes within 1e-5 absolute.  A pair of workers with a
5 s group timeout, one of which never sends, shows the exchange raising
instead of hanging.  ``communicate(timeout=300)`` kills every worker on
a hang.
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
LR_SGD = 0.05
KINDS = ("ring", "gather")
CROSSINGS = ("enter_parts", "scatter_and_exit", "ppermute", "all_gather",
             "psum")
LAYER_CASES = (("rel", (1, 8)), ("2d", (4, 2)), ("2d", (1, 8)),
               ("dst", (8, 1)), ("ring", (8, 1)))
K8_SIZES, K8_SEEDS = (2, 4, 8), (0, 1, 2)
TIMEOUT_S = 5  # the silent-peer pair's group timeout


# ---------------------------------------------------------------- worker
def _configs():
    import _multihost_common as C

    from mpqe_tpu_torch.models import mpqe as tm
    from mpqe_tpu_torch.train import loop as tloop

    cfg = tm.MPQEConfig(n_entities=C.N_ENT, n_modes=C.N_MODES,
                        n_rels=C.N_RELS, embed_dim=C.D,
                        n_layers=C.N_LAYERS, num_bases=C.BASES,
                        readout="tgt")
    adam = tloop.TrainConfig(lr=0.01, batch_size=C.B, n_neg=C.N_NEG)
    sgd = tloop.TrainConfig(lr=LR_SGD, optimizer="sgd", batch_size=C.B,
                            n_neg=C.N_NEG)
    return cfg, {"adam": adam, "sgd": sgd}


def _trajectory(named, mesh, kind, tc):
    """3 halo steps from the parameters ``named`` → (losses, final
    parameters by name)."""
    import _multihost_common as C
    import torch

    from mpqe_tpu_torch.models import mpqe as tm
    from mpqe_tpu_torch.parallel import halo_train as tht
    from mpqe_tpu_torch.train import loop as tloop

    cfg, _ = _configs()
    model = tm.MPQE(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in named.items()})
    opt = tloop.make_optimizer(tc, model.parameters())
    step = tht.make_halo_train_step(cfg, opt, mesh, kind)
    losses = []
    for g in C.global_batches():
        losses.append(float(step(model, C.STRUCT, *[
            torch.from_numpy(g[k]) for k in C.BATCH_ORDER])))
    return np.asarray(losses), {k: v.detach().numpy().copy()
                                for k, v in model.state_dict().items()}


def _crossing(name, devs, x, w, a):
    """A small function through one crossing of the parts' boundary:
    scatter ``x``, a local op per part, the crossing, the exit."""
    import torch

    from mpqe_tpu_torch.parallel import mesh as tmesh

    n = len(devs)
    mine = list(getattr(devs, "local", range(n)))
    we = tmesh.enter_parts([w], devs)[0] if name == "enter_parts" else None
    xs = tmesh.scatter_blocks(x, devs)
    h = [None] * n
    for p in mine:
        h[p] = torch.tanh(xs[p] @ we if we is not None else xs[p]) * (p + 1)
    if name == "ppermute":
        h = tmesh.ppermute(h, devs)
    elif name == "all_gather":
        full = tmesh.all_gather(h, devs)
        h = [None if f is None else a[p] @ f for p, f in enumerate(full)]
    elif name == "psum":
        h = tmesh.psum(h, devs)
    for p in mine:
        h[p] = h[p] * (p + 2)
    return tmesh.gather_blocks(h, x.device, devs)


def _crossing_run(name, devs):
    import torch

    rng = np.random.default_rng(7)
    n, b, d = len(devs), 2, 3
    x = torch.tensor(rng.normal(size=(n * b, d)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(d, d)), dtype=torch.float32,
                     requires_grad=True)
    a = torch.tensor(rng.normal(size=(n, b, n * b)), dtype=torch.float32)
    r = torch.tensor(rng.normal(size=(n * b, d)), dtype=torch.float32)
    y = _crossing(name, devs, x, w, a)
    loss = (y * r).sum() + 0.5 * (y ** 2).sum()
    gx, gw = torch.autograd.grad(loss, (x, w), allow_unused=True)
    gw = torch.zeros_like(w) if gw is None else gw
    return [t.detach().numpy() for t in (y, gx, gw)]


def _layer_inputs(seed):
    import torch

    from mpqe_tpu_torch.ops import edge_store as tes
    from mpqe_tpu_torch.ops import rgcn as trgcn

    rng = np.random.default_rng(seed)
    n, e, R, d = 64, 240, 8, 16
    st = tes.build_edge_store(rng.integers(0, n, e).astype(np.int32),
                              rng.integers(0, n, e).astype(np.int32),
                              rng.integers(0, R, e).astype(np.int32), n, R)
    layer = trgcn.init_rgcn_layer(torch.Generator().manual_seed(seed), d, d,
                                  R, 4)
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.1, generator=torch.Generator()
                           .manual_seed(seed))
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    return st, layer, x, R


def _layer_run(which, mesh):
    """One halo layer forward on ``mesh``'s parts."""
    import torch

    from mpqe_tpu_torch.parallel import halo as thalo

    st, layer, x, R = _layer_inputs(3)
    t = torch.from_numpy
    with torch.no_grad():
        if which == "rel":
            m = st.pad_mask
            return thalo.rgcn_rel_partitioned(
                mesh, layer, x, t(st.src[m]), t(st.dst[m]), t(st.rel[m]),
                t(st.norm[m]), R).numpy()
        if which == "ring":
            pr = thalo.partition_edges_ring(st, mesh.shape["data"])
            return thalo.rgcn_ring_halo(
                mesh, layer, t(thalo.pad_node_features(x.numpy(), pr)),
                t(pr.src_local), t(pr.dst_local), t(pr.rel), t(pr.norm),
                R).numpy()
        pe = thalo.partition_edges_by_dst(st, mesh.shape["data"])
        fn = (thalo.rgcn_2d_partitioned if which == "2d"
              else thalo.rgcn_dst_partitioned)
        return fn(mesh, layer, t(thalo.pad_node_features(x.numpy(), pe)),
                  t(pe.src), t(pe.dst_local), t(pe.rel), t(pe.norm),
                  R).numpy()


def _k8_run(mesh, P, seed):
    import torch

    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.parallel import halo as thalo

    st, layer, x, R = _layer_inputs(10 + seed)
    pr = thalo.partition_edges_ring(st, P)
    t = torch.from_numpy
    return ring.rgcn_ring_halo_rdma_reference(
        mesh, layer, t(thalo.pad_node_features(x.numpy(), pr)),
        t(pr.src_local), t(pr.dst_local), t(pr.rel), t(pr.norm),
        R).numpy()


def _summed_exit():
    """The exit's backward with the processes' cotangents summed (each
    process holds the whole cotangent already): the negative control."""
    from mpqe_tpu_torch.parallel import mesh as tmesh
    from mpqe_tpu_torch.parallel import multihost

    honest = tmesh._Gather.backward

    def summed(ctx, g):
        got = multihost.exchange([g.contiguous()], g.device, "summed exit")
        return honest(ctx, got[0][0] + got[1][0])

    return honest, summed


def _worker(argv):
    port, rank, params_npz, out = argv[0], int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import torch

    from mpqe_tpu_torch.parallel import mesh as tmesh
    from mpqe_tpu_torch.parallel import multihost

    silent = params_npz == "-"
    assert multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=rank, device="cpu",
        timeout_s=TIMEOUT_S if silent else 300)
    if silent:  # rank 1 never sends; rank 0's exchange must raise
        if rank == 1:
            time.sleep(6 * TIMEOUT_S)
            return
        t0 = time.perf_counter()
        try:
            multihost.exchange([torch.ones(3)], "cpu", "never answered")
        except Exception as e:
            print(f"RAISED {type(e).__name__} after "
                  f"{time.perf_counter() - t0:.1f} s: {e}", flush=True)
            sys.exit(3)
        sys.exit(0)

    with np.load(params_npz) as z:
        named = {k: z[k] for k in z.files}
    two = multihost.global_mesh((8, 1), ["cpu"] * 4)
    assert two.local_devices() == [torch.device("cpu")] * 4
    assert [p for p, _ in two.local_parts("data")] == list(
        range(4 * rank, 4 * rank + 4))
    one = tmesh.make_mesh((8, 1), devices=["cpu"] * 8)
    _, tcs = _configs()
    res = {}
    for kind in KINDS:
        for opt, tc in tcs.items():
            for where, mesh in (("two", two), ("one", one)):
                losses, params = _trajectory(named, mesh, kind, tc)
                res[f"{where}/{kind}/{opt}/losses"] = losses
                for k, v in params.items():
                    res[f"{where}/{kind}/{opt}/{k}"] = (
                        v - named[k] if opt == "sgd" else v)
    honest, summed = _summed_exit()
    tmesh._Gather.backward = staticmethod(summed)
    losses, params = _trajectory(named, two, "ring", tcs["sgd"])
    tmesh._Gather.backward = staticmethod(honest)
    for k, v in params.items():
        res[f"control/{k}"] = v - named[k]
    for name in CROSSINGS:
        for where, mesh in (("two", two), ("one", one)):
            for i, v in enumerate(_crossing_run(
                    name, mesh.axis_devices("data"))):
                res[f"{where}/crossing/{name}/{i}"] = v
    for which, shape in LAYER_CASES:
        key = f"{which}/{shape[0]}x{shape[1]}"
        res[f"two/layer/{key}"] = _layer_run(
            which, multihost.global_mesh(shape, ["cpu"] * 4))
        res[f"one/layer/{key}"] = _layer_run(
            which, tmesh.make_mesh(shape, devices=["cpu"] * 8))
    for P in K8_SIZES:
        for seed in K8_SEEDS:
            res[f"two/k8/{P}/{seed}"] = _k8_run(
                multihost.global_mesh((P, 1), ["cpu"] * (P // 2)), P, seed)
            res[f"one/k8/{P}/{seed}"] = _k8_run(
                tmesh.make_mesh((P, 1), devices=["cpu"] * P), P, seed)
    from mpqe_tpu_torch.tools import multihost_run

    cli = multihost_run.main([
        "--device", "cpu", "--parallel", "halo_ring", "--mesh", "2,1",
        "--entities", "300", "--embed_dim", "16", "--num_bases", "4",
        "--batch_size", "32", "--params", "--out",
        os.path.join(os.path.dirname(out), "cli")])
    res["cli/losses"] = np.asarray(cli["losses"])
    np.savez(out, **res)


# ----------------------------------------------------------------- tests
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_runs(named_out):
    """The JAX package's single-process 8-device halo steps from
    ``init_halo_train_state(PRNGKey(0))``: (initial parameters by name,
    {(kind, opt): (losses, final parameters by name)})."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import _multihost_common as C
    from mpqe_tpu.parallel import halo_train as jht
    from mpqe_tpu.parallel import mesh as jmesh
    from mpqe_tpu.train import loop as jloop

    def named(params):
        out = {"emb.ent": params["emb"]["ent"],
               "emb.var": params["emb"]["var"]}
        for i, lp in enumerate(params["layers"]):
            out.update({f"layers.{i}.{k}": v for k, v in lp.items()})
        for k, v in params.get("readout", {}).items():
            out[f"readout.{k}"] = v
        return {k: np.asarray(v) for k, v in out.items()}

    cfg = C.model_config()
    mesh = jmesh.make_mesh((8, 1), devices=jax.devices()[:8])
    rep = NamedSharding(mesh, P())
    tcs = {"adam": C.train_config(),
           "sgd": jloop.TrainConfig(lr=LR_SGD, optimizer="sgd",
                                    batch_size=C.B, n_neg=C.N_NEG)}
    init = None
    runs = {}
    with jax.default_matmul_precision("highest"):
        for kind in KINDS:
            for opt, tc in tcs.items():
                state = jht.init_halo_train_state(jax.random.PRNGKey(0),
                                                  cfg, tc, mesh)
                if init is None:
                    init = named(state.params)
                    np.savez(named_out, **init)
                step = jht.make_halo_train_step(cfg, tc, mesh,
                                                layer_kind=kind)
                p, o = state.params, state.opt_state
                losses = []
                for g in C.global_batches():
                    arrs = {k: jax.device_put(np.asarray(v), rep)
                            for k, v in g.items()}
                    p, o, loss = step(p, o, C.STRUCT,
                                      *[arrs[k] for k in C.BATCH_ORDER])
                    losses.append(float(loss))
                runs[(kind, opt)] = (np.asarray(losses), named(p))
    return init, runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, then the two workers (which compute the port in one
    process beside their own runs), and the silent-peer pair."""
    sys.path.insert(0, HERE)
    tmp = tmp_path_factory.mktemp("multihost_halo")
    params_npz = str(tmp / "params.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # the silent pair first: it runs while the JAX oracle compiles
    lone = _free_port()
    silent = [subprocess.Popen(
        [sys.executable, __file__, str(lone), str(r), "-", "-"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for r in (0, 1)]
    init, jax_runs = _jax_runs(params_npz)
    port = _free_port()
    outs = [str(tmp / f"w{r}" / "out.npz") for r in (0, 1)]
    for o in outs:
        os.makedirs(os.path.dirname(o))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), params_npz, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for r in (0, 1)]
    results = []
    t0 = time.perf_counter()
    for p in silent + procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in silent + procs:
                q.kill()
            raise
        results.append((p.returncode, out, err, time.perf_counter() - t0))
    for rc, _, err, _ in results[2:]:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
    workers = []
    for o in outs:
        with np.load(o) as z:
            workers.append({k: z[k] for k in z.files})
    return dict(init=init, jax=jax_runs, workers=workers,
                silent=results[0])


def _params(res, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix)
            and not k.endswith("/losses")}


def test_ranks_are_bit_equal(runs):
    a, b = runs["workers"]
    assert set(a) == set(b)
    for k in a:
        if k.startswith("two/") or k.startswith("control/") or \
                k.startswith("cli/"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.isfinite(a["two/ring/adam/losses"]).all()


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("kind", KINDS)
def test_halo_losses_match_one_process(runs, kind, opt):
    w = runs["workers"][0]
    got, want = w[f"two/{kind}/{opt}/losses"], w[f"one/{kind}/{opt}/losses"]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_halo_losses_match_jax(runs, kind):
    """The reference's oracle and tolerance: its 8-device single-process
    halo step under its Adam config."""
    got = runs["workers"][0][f"two/{kind}/adam/losses"]
    want = runs["jax"][(kind, "adam")][0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("oracle", ["port_one_process", "jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_halo_sgd_changes_match(runs, kind, oracle):
    w = runs["workers"][0]
    got = _params(w, f"two/{kind}/sgd/")
    if oracle == "jax":
        losses, final = runs["jax"][(kind, "sgd")]
        want = {k: v - runs["init"][k] for k, v in final.items()}
        np.testing.assert_allclose(w[f"two/{kind}/sgd/losses"], losses,
                                   rtol=1e-5, atol=0)
    else:
        want = _params(w, f"one/{kind}/sgd/")
    assert set(got) == set(want)
    assert any(np.abs(v).max() > 1e-4 for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)


def test_summed_exit_control_fails_the_change_check(runs):
    """An exit whose backward sums the processes' cotangents doubles the
    last layer's gradients: its SGD changes fail the check of
    ``test_halo_sgd_changes_match`` by about a factor of 2."""
    w = runs["workers"][0]
    got, want = _params(w, "control/"), _params(w, "one/ring/sgd/")
    worst = max(np.abs(got[k] - v).max() for k, v in want.items())
    assert worst > 1e-5
    last = f"layers.{max(int(k.split('.')[1]) for k in want if k.startswith('layers.'))}.w_self"
    ratio = np.linalg.norm(got[last]) / np.linalg.norm(want[last])
    assert 1.9 < ratio < 2.1, ratio


@pytest.mark.parametrize("name", CROSSINGS)
def test_crossing_matches_one_process(runs, name):
    """Forward and the gradients of ``x`` and of the entering parameter
    through each crossing equal the one-process collective: every output
    and the copies' gradients bit for bit; the sums' gradients within
    1e-6 (the transposes of all_gather, psum and enter_parts add in part
    or process order, autograd in its own)."""
    w = runs["workers"][0]
    for i, what in enumerate(("output", "grad x", "grad w")):
        got = w[f"two/crossing/{name}/{i}"]
        want = w[f"one/crossing/{name}/{i}"]
        assert np.abs(want).max() > 0 or what == "grad w"
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=what)
        if name in ("scatter_and_exit", "ppermute") or i == 0:
            np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("which,shape", LAYER_CASES)
def test_layers_across_processes_forward(runs, which, shape):
    key = f"{which}/{shape[0]}x{shape[1]}"
    for w in runs["workers"]:
        np.testing.assert_array_equal(w[f"two/layer/{key}"],
                                      w[f"one/layer/{key}"])


@pytest.mark.parametrize("seed", K8_SEEDS)
@pytest.mark.parametrize("P", K8_SIZES)
def test_plain_k8_across_processes_bit_equal(runs, P, seed):
    for w in runs["workers"]:
        got, want = w[f"two/k8/{P}/{seed}"], w[f"one/k8/{P}/{seed}"]
        assert np.abs(want).max() > 0
        np.testing.assert_array_equal(got, want)


def test_multihost_run_halo_cli_matches_one_process(runs):
    from mpqe_tpu_torch.tools import multihost_run

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        one = multihost_run.main([
            "--device", "cpu", "--parallel", "halo_ring", "--mesh", "4,1",
            "--entities", "300", "--embed_dim", "16", "--num_bases", "4",
            "--batch_size", "32", "--out", tmp])
    got = runs["workers"][0]["cli/losses"]
    np.testing.assert_allclose(got, one["losses"], rtol=1e-6, atol=0)


def test_a_peer_that_never_sends_raises(runs):
    rc, out, err, seconds = runs["silent"]
    assert rc == 3, f"rc={rc}\n{out}\n{err[-2000:]}"
    assert "RAISED" in out
    assert seconds < 120


def test_transports_refuse_what_they_do_not_take():
    """No silent staging: a tensor on another device than the exchange's
    and a device with no transport raise before any group call; the
    gloo transport takes CPU tensors only."""
    import torch

    from mpqe_tpu_torch.parallel import multihost

    meta = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="no transport for meta"):
        multihost.exchange([meta], "meta")
    with pytest.raises(ValueError, match="handed a tensor on meta"):
        multihost.exchange([meta], "cpu")
    with pytest.raises(ValueError, match="gloo transport takes CPU"):
        multihost._gloo_exchange([meta], [1, 1], (3,), torch.float32)


def test_global_mesh_in_one_process_is_make_mesh():
    import torch

    from mpqe_tpu_torch.parallel import mesh as tmesh
    from mpqe_tpu_torch.parallel import multihost

    m = multihost.global_mesh((4, 2), ["cpu"] * 8)
    assert m.procs is None and not m.spans_processes
    assert m.shape == {"data": 4, "model": 2}
    assert type(m.axis_devices("data")) is list
    assert m.local_parts("model") == [(0, torch.device("cpu")),
                                      (1, torch.device("cpu"))]
    assert m.local_devices() == [torch.device("cpu")] * 8
    parts = [torch.ones(2)] * 4
    devs = [torch.device("cpu")] * 4
    assert tmesh.enter_parts(parts[:1], devs)[0] is parts[0]


def test_axis_devices_of_a_mesh_over_processes():
    """A (4, 2) grid whose rows 0-1 are process 0's: the data axis spans
    both processes; each model row lies in one; ``axis_devices`` takes
    the first row this process holds."""
    import numpy as np_
    import torch

    from mpqe_tpu_torch.parallel import mesh as tmesh

    devs = np_.empty(8, dtype=object)
    devs[:] = [torch.device("cpu")] * 8
    procs = np_.repeat([0, 1], 4)
    m = tmesh.Mesh(devs.reshape(4, 2), ("data", "model"), procs=procs,
                   rank=1)
    assert m.spans_processes
    data = m.axis_devices("data")
    assert isinstance(data, tmesh.AxisDevices)
    assert data.procs == [0, 0, 1, 1] and data.local == [2, 3]
    assert data.spans and data.world == 2
    row = m.axis_devices("model")
    assert row.procs == [1, 1] and not row.spans
    assert tmesh._mode(row) == "local"
    assert tmesh._mode(m.axis_devices("model", 0)) == "remote"
    assert [p for p, _ in m.local_parts("data", 1)] == [2, 3]
    assert tmesh.scatter_blocks(torch.ones(4, 1),
                                m.axis_devices("model", 0)) == [None] * 2


@pytest.mark.parametrize("which", ["rel", "2d"])
def test_rel_and_2d_layers_refuse_grad_across_processes(which):
    """Across processes the relation-partitioned and 2-D layers run
    forward only: in grad mode they raise before any exchange."""
    import numpy as np_
    import torch

    from mpqe_tpu_torch.parallel import mesh as tmesh

    devs = np_.empty(8, dtype=object)
    devs[:] = [torch.device("cpu")] * 8
    mesh = tmesh.Mesh(devs.reshape(1, 8), ("data", "model"),
                      procs=np_.repeat([0, 1], 4), rank=0)
    with pytest.raises(NotImplementedError, match="forward only"):
        _layer_run_grad(which, mesh)


def _layer_run_grad(which, mesh):
    import torch

    from mpqe_tpu_torch.parallel import halo as thalo

    st, layer, x, R = _layer_inputs(3)
    t = torch.from_numpy
    if which == "rel":
        m = st.pad_mask
        return thalo.rgcn_rel_partitioned(
            mesh, layer, x, t(st.src[m]), t(st.dst[m]), t(st.rel[m]),
            t(st.norm[m]), R)
    pe = thalo.partition_edges_by_dst(st, 1)
    return thalo.rgcn_2d_partitioned(
        mesh, layer, t(thalo.pad_node_features(x.numpy(), pe)), t(pe.src),
        t(pe.dst_local), t(pe.rel), t(pe.norm), R)


if __name__ == "__main__":
    _worker(sys.argv[1:])
