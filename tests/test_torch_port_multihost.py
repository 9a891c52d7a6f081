"""Two processes of the port's data-parallel step under
``torch.distributed`` (``mpqe_tpu_torch/parallel/multihost.py``,
``parallel/spmd.py``) on the CPU, mirroring ``tests/test_multihost.py``.

This file is also the worker: ``python <this file> <port> <rank>
<params.npz> <out.npz>`` joins a two-process ``gloo`` group at
``127.0.0.1:<port>``, builds its own ``(4, 1)`` mesh on the CPU, and runs
3 spmd steps over ``tests/_multihost_common.py``'s config and batches,
each process feeding its half of every global batch through
``host_local_batch``; it writes its losses and final parameters to
``<out.npz>``.  The test runs two workers (``communicate(timeout=300)``
kills both on a hang) and holds them against each other, against the
port in one process over the global batch on an ``(8, 1)`` mesh, and
against the JAX package's spmd step on 8 of the conftest's CPU devices
(losses within 1e-5 relative, parameters within 1e-5 absolute; SGD, see
``tests/test_torch_port_spmd.py``).  A third worker, alone in a group of
two, must fail instead of training by itself.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LR = 0.05


def _port_config():
    import _multihost_common as C

    from mpqe_tpu_torch.models import mpqe as tm
    from mpqe_tpu_torch.train import loop as tloop

    cfg = tm.MPQEConfig(n_entities=C.N_ENT, n_modes=C.N_MODES,
                        n_rels=C.N_RELS, embed_dim=C.D,
                        n_layers=C.N_LAYERS, num_bases=C.BASES,
                        readout="tgt")
    tc = tloop.TrainConfig(lr=LR, optimizer="sgd", batch_size=C.B,
                           n_neg=C.N_NEG)
    return cfg, tc


def _load_model(params_npz, cfg):
    with np.load(params_npz) as z:
        return _from_named({k: z[k] for k in z.files}, cfg)


def _from_named(named, cfg):
    import torch

    from mpqe_tpu_torch.models import mpqe as tm

    model = tm.MPQE(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in named.items()})
    return model


def _run_port(mesh, model, cfg, tc, batches, lo, hi):
    """3 spmd steps of ``model`` on ``mesh`` over rows [lo, hi) of each
    global batch → (losses, final named parameters)."""
    import _multihost_common as C

    from mpqe_tpu_torch.parallel import multihost, spmd

    state = spmd.place_train_state(model, tc, mesh)
    _, step = spmd.make_spmd_train_step(cfg, tc, mesh)
    losses = []
    for g in batches:
        local = {k: (v if k in ("edge_rel", "edge_norm") else v[lo:hi])
                 for k, v in g.items()}
        arrays = multihost.host_local_batch(mesh, local)
        losses.append(float(step(state.model, C.STRUCT,
                                 *[arrays[k] for k in C.BATCH_ORDER])))
    return losses, {k: v.numpy() for k, v in state.model.state_dict().items()}


def _worker(argv):
    port, rank, params_npz, out = argv[0], int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import _multihost_common as C

    from mpqe_tpu_torch.parallel import mesh as tmesh
    from mpqe_tpu_torch.parallel import multihost

    alone = out == "-"
    assert multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=rank, device="cpu", timeout_s=5 if alone else 300)
    assert multihost.process_count() == 2
    assert multihost.process_index() == rank
    cfg, tc = _port_config()
    mesh = tmesh.make_mesh((4, 1), devices=["cpu"] * 4)
    half = C.B // 2
    lo, hi = (0, half) if rank == 0 else (half, C.B)
    losses, params = _run_port(mesh, _load_model(params_npz, cfg), cfg, tc,
                               C.global_batches(), lo, hi)
    np.savez(out, losses=np.asarray(losses), **params)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run, the port in one process, and the two workers."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, HERE)
    import _multihost_common as C

    from mpqe_tpu.parallel import mesh as jmesh
    from mpqe_tpu.parallel import spmd as jspmd
    from mpqe_tpu.train import loop as jloop
    from mpqe_tpu_torch.parallel import mesh as tmesh

    tmp = tmp_path_factory.mktemp("multihost")
    cfg = C.model_config()
    jtc = jloop.TrainConfig(lr=LR, optimizer="sgd", batch_size=C.B,
                            n_neg=C.N_NEG)
    mesh = jmesh.make_mesh((8, 1), devices=jax.devices()[:8])
    init_fn, step = jspmd.make_spmd_train_step(cfg, jtc, mesh,
                                               shard_entity_table=True)
    params, opt = init_fn(jax.random.PRNGKey(0))
    named = {"emb.ent": params["emb"]["ent"], "emb.var": params["emb"]["var"]}
    for i, lp in enumerate(params["layers"]):
        named.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    named = {k: np.asarray(v) for k, v in named.items()}
    params_npz = str(tmp / "params.npz")
    np.savez(params_npz, **named)

    # the workers start first, so that they run beside the oracles
    port, lone = _free_port(), _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    outs = [str(tmp / f"rank{r}.npz") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), params_npz, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for r in (0, 1)]
    alone = subprocess.Popen(
        [sys.executable, __file__, str(lone), "0", params_npz, "-"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)

    batch_sh = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    j_losses = []
    with jax.default_matmul_precision("highest"):
        for g in C.global_batches():
            arrs = {k: jax.device_put(np.asarray(v), rep if k in (
                "edge_rel", "edge_norm") else batch_sh)
                for k, v in g.items()}
            params, opt, loss = step(params, opt, C.STRUCT,
                                     *[arrs[k] for k in C.BATCH_ORDER])
            j_losses.append(float(loss))
    j_params = {"emb.ent": params["emb"]["ent"],
                "emb.var": params["emb"]["var"]}
    for i, lp in enumerate(params["layers"]):
        j_params.update({f"layers.{i}.{k}": v for k, v in lp.items()})

    pcfg, tc = _port_config()
    one = _run_port(tmesh.make_mesh((8, 1), devices=["cpu"] * 8),
                    _from_named(named, pcfg), pcfg, tc, C.global_batches(),
                    0, C.B)

    results = []
    for p in procs + [alone]:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs + [alone]:
                q.kill()
            raise
        results.append((p.returncode, err))
    for rc, err in results[:2]:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
    workers = []
    for o in outs:
        with np.load(o) as z:
            workers.append({k: z[k] for k in z.files})
    return dict(jax=(j_losses, {k: np.asarray(v) for k, v in
                                j_params.items()}),
                one=one, workers=workers, alone=results[2])


def test_two_processes_agree(runs):
    a, b = runs["workers"]
    assert len(a["losses"]) == 3 and np.isfinite(a["losses"]).all()
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("oracle", ["port_one_process", "jax"])
def test_two_processes_match_one_process(runs, oracle):
    losses, params = runs["one"] if oracle == "port_one_process" else \
        runs["jax"]
    got = runs["workers"][0]
    for want, g in zip(losses, got["losses"]):
        assert abs(want - g) <= 1e-5 * abs(want), (losses, got["losses"])
    assert set(params) == set(got) - {"losses"}
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)


def test_a_process_without_its_peer_fails(runs):
    rc, err = runs["alone"]
    assert rc != 0, "a process alone in a group of two trained by itself"


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    import torch.distributed as dist

    from mpqe_tpu_torch.parallel import multihost

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda") == "nccl"
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize(coordinator_address="127.0.0.1:1")


def test_host_local_batch_single_process():
    """One process: the local arrays are the global ones, the [B, ...]
    arrays split over the data parts, the per-formula ones on each."""
    import torch

    from mpqe_tpu_torch.parallel import mesh as tmesh
    from mpqe_tpu_torch.parallel import multihost

    rng = np.random.default_rng(0)
    arrays = {
        "node_entity": rng.integers(0, 100, (16, 4)).astype(np.int32),
        "target": rng.integers(0, 100, (16,)).astype(np.int32),
        "edge_rel": np.array([1, 2, 3], np.int32),
        "edge_norm": np.ones(3, np.float32),
    }
    mesh = tmesh.make_mesh((8, 1), devices=["cpu"] * 8)
    out = multihost.host_local_batch(mesh, arrays)
    assert len(out["node_entity"]) == 8
    np.testing.assert_array_equal(torch.cat(out["node_entity"]).numpy(),
                                  arrays["node_entity"])
    assert all(t.shape == (2, 4) for t in out["node_entity"])
    for t in out["edge_rel"]:
        np.testing.assert_array_equal(t.numpy(), arrays["edge_rel"])
    with pytest.raises(ValueError, match="data axis"):
        multihost.host_local_batch(mesh, arrays, data_axis="model")


if __name__ == "__main__":
    _worker(sys.argv[1:])
