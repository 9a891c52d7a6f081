"""The parallel layer's halo slice of the PyTorch port
(``mpqe_tpu_torch/parallel/{mesh,halo,halo_train}.py`` and ``--parallel
halo_ring|halo_gather``) against the JAX package.

The JAX side runs ``shard_map`` on the conftest's virtual 8-device CPU
mesh; the port runs the same partitions as a list of parts on the CPU
(``make_mesh(..., devices=["cpu"] * P)``).  The JAX side is called
sparingly (its halo training under ``shard_map`` is slow): the layers and
``halo_dense_batch_loss`` once each against JAX, and the reference's own
training checks (``tests/test_parallel.py``: the halo loss equals the
dense loss; a halo trajectory follows the single-device one) against the
port's dense path, which is itself held to JAX.

Tolerances (max|diff| / max|ref|): f32 on both sides, only the order of
the sums differs: 1e-5 for layers, losses and gradients.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import edge_store as jes
from mpqe_tpu.ops import rgcn as jrgcn
from mpqe_tpu.parallel import halo as jhalo
from mpqe_tpu.parallel import halo_train as jht
from mpqe_tpu.parallel import mesh as jmesh
from mpqe_tpu.queries import STRUCTURE_NAMES, STRUCTURES
from mpqe_tpu_torch.convert import layer_from_numpy, model_from_numpy
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import edge_store as tes
from mpqe_tpu_torch.ops import rgcn as trgcn
from mpqe_tpu_torch.parallel import halo as thalo
from mpqe_tpu_torch.parallel import halo_train as tht
from mpqe_tpu_torch.parallel import mesh as tmesh
from mpqe_tpu_torch.train import loop as tloop

D, N_RELS = 16, 8
TOL = 1e-5
N_ENT, N_MODES = 60, 3


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cpu_mesh(shape):
    return tmesh.make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _jax_mesh(shape):
    return jmesh.make_mesh(shape,
                           devices=jax.devices()[: shape[0] * shape[1]])


def _layer(nb, seed):
    params = jrgcn.init_rgcn_layer(jax.random.PRNGKey(seed), D, D, N_RELS,
                                   nb)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["bias"] = (0.1 * np.random.default_rng(seed).normal(
        size=params["bias"].shape)).astype(np.float32)
    return params, layer_from_numpy(params, "cpu")


def _stores(seed, n_nodes=64, n_e=240):
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, n_nodes, n_e).astype(np.int32),
         rng.integers(0, n_nodes, n_e).astype(np.int32),
         rng.integers(0, N_RELS, n_e).astype(np.int32))
    return (jes.build_edge_store(*a, n_nodes, N_RELS),
            tes.build_edge_store(*a, n_nodes, N_RELS))


# ------------------------------------------------------------ partitioners
@pytest.mark.parametrize("n_parts", [3, 4])
@pytest.mark.parametrize("kind", ["by_dst", "ring"])
def test_partitioners_match_jax(kind, n_parts):
    js, ts = _stores(n_parts, n_nodes=50, n_e=300)
    fn = "partition_edges_by_dst" if kind == "by_dst" else \
        "partition_edges_ring"
    want = getattr(jhalo, fn)(js, n_parts)
    got = getattr(thalo, fn)(ts, n_parts)
    for f in ("src", "src_local", "dst_local", "rel", "norm"):
        if hasattr(want, f):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype
    for f in ("n_parts", "block_size", "n_nodes", "n_rels",
              "n_nodes_padded"):
        assert getattr(got, f) == getattr(want, f)
    if kind == "by_dst":
        x = np.random.default_rng(0).normal(size=(50, D)).astype(np.float32)
        np.testing.assert_array_equal(thalo.pad_node_features(x, got),
                                      jhalo.pad_node_features(x, want))


# ------------------------------------------------------------------ layers
def _layer_case(which, seed, nb):
    """(JAX call, port call) of one layer on 4 parts (2d: 2 x 2)."""
    js, ts = _stores(seed)
    params, layer = _layer(nb, seed)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(seed)
    if which == "rel":
        x = rng.normal(size=(ts.n_nodes, D)).astype(np.float32)
        edges = (ts.src, ts.dst, ts.rel, ts.norm)
        shape, jfn, tfn = (1, 4), jhalo.rgcn_rel_partitioned, \
            thalo.rgcn_rel_partitioned
    else:
        part = (thalo.partition_edges_ring if which == "ring"
                else thalo.partition_edges_by_dst)(ts, 2 if which == "2d"
                                                   else 4)
        x = rng.normal(size=(part.n_nodes_padded, D)).astype(np.float32)
        edges = (part.src_local if which == "ring" else part.src,
                 part.dst_local, part.rel, part.norm)
        shape = (2, 2) if which == "2d" else (4, 1)
        jfn = {"dst": jhalo.rgcn_dst_partitioned,
               "2d": jhalo.rgcn_2d_partitioned,
               "ring": jhalo.rgcn_ring_halo}[which]
        tfn = {"dst": thalo.rgcn_dst_partitioned,
               "2d": thalo.rgcn_2d_partitioned,
               "ring": thalo.rgcn_ring_halo}[which]

    def jcall():
        # jitted: eager shard_map dispatches every op of every hop alone
        fn = jax.jit(lambda p, *a: jfn(_jax_mesh(shape), p, *a, N_RELS))
        with jax.default_matmul_precision("highest"):
            return np.asarray(fn(jp, jnp.asarray(x),
                                 *map(jnp.asarray, edges)))

    def tcall(x_t=None, lay=layer):
        return tfn(_cpu_mesh(shape), lay, _t(x) if x_t is None else x_t,
                   *map(_t, edges), N_RELS)

    return jcall, tcall, ts, x, layer


@pytest.mark.parametrize("nb", [None, 3], ids=["w_rel", "basis"])
@pytest.mark.parametrize("which", ["dst", "rel", "2d", "ring"])
def test_halo_layers_match_jax(which, nb):
    jcall, tcall, *_ = _layer_case(which, 5, nb)
    with torch.no_grad():
        got = tcall()
    want = jcall()
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("nb", [None, 3], ids=["w_rel", "basis"])
@pytest.mark.parametrize("which", ["dst", "ring"])
def test_halo_layer_gradients_match_rgcn_sparse(which, nb):
    # autograd through the parts, their copies and collectives gives the
    # single-device layer's gradients (x and every parameter)
    _, tcall, ts, x, layer = _layer_case(which, 6, nb)
    n = ts.n_nodes
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(x.shape[0], D)).astype(np.float32))
    x_a = _t(x).requires_grad_(True)
    out = tcall(x_a)
    grads_a = torch.autograd.grad((out * g).sum(),
                                  [x_a, *layer.parameters()])
    x_b = _t(x[:n]).requires_grad_(True)
    ref = trgcn.rgcn_sparse(x_b, layer, _t(ts.src), _t(ts.dst), _t(ts.rel),
                            _t(ts.norm), N_RELS)
    grads_b = torch.autograd.grad((ref * g[:n]).sum(),
                                  [x_b, *layer.parameters()])
    assert _rel(grads_a[0][:n].numpy(), grads_b[0].numpy()) <= TOL
    for a, b in zip(grads_a[1:], grads_b[1:]):
        assert _rel(a.numpy(), b.numpy()) <= TOL


def test_mesh_shapes_and_collectives():
    m = _cpu_mesh((2, 3))
    assert m.shape == {"data": 2, "model": 3}
    assert tmesh.data_axis(m) == "data" and tmesh.model_axis(m) == "model"
    assert len(m.axis_devices("data")) == 2
    assert len(m.axis_devices("model")) == 3
    assert tmesh.make_mesh((-1, 2), devices=["cpu"] * 6).shape == {
        "data": 3, "model": 2}
    assert tmesh.make_mesh(devices=["cpu"] * 4).shape == {"data": 4,
                                                         "model": 1}
    with pytest.raises(ValueError, match="mesh shape 2x2 != 3 devices"):
        tmesh.make_mesh((2, 2), devices=["cpu"] * 3)
    devs = [torch.device("cpu")] * 3
    parts = [torch.full((2,), float(p), requires_grad=True)
             for p in range(3)]
    assert [t.tolist() for t in tmesh.ppermute(parts, devs)] == [
        [2.0, 2.0], [0.0, 0.0], [1.0, 1.0]]
    gathered = tmesh.all_gather(parts, devs)
    assert gathered[1].tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
    summed = tmesh.psum(parts, devs)
    assert summed[2].tolist() == [3.0, 3.0]
    grads = torch.autograd.grad(gathered[0].sum() + 2 * summed[1].sum(),
                                parts)
    assert [g.tolist() for g in grads] == [[3.0, 3.0]] * 3


# ---------------------------------------------------------------- training
def _models(seed=3, n_layers=2):
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
              embed_dim=D, n_layers=n_layers, num_bases=4, readout="tgt")
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:  # non-zero biases (init is zeros)
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _loss_inputs(structure, B=16, K=4, seed=10):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_RELS, (spec.n_edges,)).astype(np.int32),
            rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(np.float32),
            rng.integers(0, N_ENT, (B,)).astype(np.int32),
            rng.integers(0, N_ENT, (B, K)).astype(np.int32),
            (rng.random((B, K)) > 0.2).astype(np.float32),
            (np.arange(B) < B - 3).astype(np.float32))


def _grads(model, loss):
    gs = torch.autograd.grad(loss, list(model.parameters()),
                             allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g)
            for (n, p), g in zip(model.named_parameters(), gs)}


@pytest.mark.parametrize("kind", ["ring", "gather"])
def test_halo_loss_matches_jax(kind):
    jcfg, tcfg, params, model = _models()
    structure = "3-inter_chain"
    arrays = _loss_inputs(structure)
    jmesh4 = _jax_mesh((4, 1))
    fn = jax.jit(lambda p, *a: jht.halo_dense_batch_loss(
        p, jcfg, jmesh4, kind, structure, *a))
    with jax.default_matmul_precision("highest"):
        want = float(fn(params, *map(jnp.asarray, arrays)))
    with torch.no_grad():
        got = tht.halo_dense_batch_loss(model, tcfg, _cpu_mesh((4, 1)), kind,
                                        structure, *map(_t, arrays))
    assert abs(float(got) - want) <= TOL * abs(want)


@pytest.mark.parametrize("kind", ["ring", "gather"])
def test_halo_loss_equals_dense_loss_every_structure(kind):
    # the reference's own check (tests/test_parallel.py:308), with
    # gradients, against the port's dense path
    _, tcfg, _, model = _models(n_layers=3)
    mesh = _cpu_mesh((4, 1))
    for structure in STRUCTURE_NAMES:
        arrays = [_t(a) for a in _loss_inputs(structure, B=12, seed=20)]
        want = tm.dense_batch_loss(model, tcfg, structure, *arrays)
        got = tht.halo_dense_batch_loss(model, tcfg, mesh, kind, structure,
                                        *arrays)
        lg, lw = float(got.detach()), float(want.detach())
        assert abs(lg - lw) <= TOL * abs(lw), structure
        g_got, g_want = _grads(model, got), _grads(model, want)
        for n, w in g_want.items():
            if w.abs().max() > 0:
                assert _rel(g_got[n].numpy(), w.numpy()) <= TOL, (
                    structure, n)


@pytest.mark.parametrize("kind", ["ring", "gather"])
def test_halo_train_trajectory_matches_single_device(kind):
    # the reference's own check (tests/test_parallel.py:254): 3 steps
    # through the halo layers follow the dense single-device trajectory
    # (losses and final parameters)
    _, tcfg, _, _ = _models()
    tc = tloop.TrainConfig(lr=0.02, batch_size=16, n_neg=4)
    mesh = _cpu_mesh((4, 1))
    gen = torch.Generator().manual_seed(7)
    state_a = tloop.init_train_state(gen, tcfg, tc, device="cpu")
    gen = torch.Generator().manual_seed(7)
    state_b = tht.init_halo_train_state(gen, tcfg, tc, mesh)
    step_a = tloop.make_train_step(tcfg, state_a.optimizer)
    step_b = tht.make_halo_train_step(tcfg, state_b.optimizer, mesh,
                                      layer_kind=kind)
    arrays = [_t(a) for a in _loss_inputs("2-chain")]
    for t in range(3):
        la = float(step_a(state_a.model, "2-chain", *arrays))
        lb = float(step_b(state_b.model, "2-chain", *arrays))
        assert abs(lb - la) <= 2e-5 + TOL * abs(la), t
    for (n, a), b in zip(state_a.model.named_parameters(),
                         state_b.model.parameters()):
        assert _rel(b.detach().numpy(), a.detach().numpy()) <= 1e-4, n


def test_halo_train_refusals():
    _, tcfg, _, _ = _models()
    tc = tloop.TrainConfig(batch_size=16, n_neg=4)
    mesh = _cpu_mesh((2, 1))
    # shard_entity_table=True is ported: the table row-sharded over the
    # mesh's model axis (one part here), the layer weights replicated
    from mpqe_tpu_torch.parallel import sharding as tsh

    st = tht.init_halo_train_state(torch.Generator(), tcfg, tc, mesh,
                                   shard_entity_table=True)
    assert isinstance(st.model.emb.ent, tsh.RowShardedTable)
    assert len(st.model.emb.ent.blocks) == 1
    assert isinstance(st.model.layers[0].basis, torch.nn.Parameter)
    # the halo multistep step is ported (tests/test_torch_port_multistep.py);
    # like the single step it refuses an unknown layer kind when called
    model = tloop.init_train_state(torch.Generator().manual_seed(0), tcfg,
                                   tc).model
    step = tht.make_halo_multistep_train_step(
        tcfg, tloop.make_optimizer(tc, model.parameters()), mesh,
        layer_kind="bogus")
    spec = STRUCTURES["1-chain"]
    arrays = [torch.zeros((2, 16, spec.n_nodes), dtype=torch.int32),
              torch.zeros((2, 16, spec.n_nodes), dtype=torch.int32),
              torch.zeros((2, spec.n_edges), dtype=torch.int32),
              torch.ones((2, spec.n_edges)),
              torch.zeros((2, 16), dtype=torch.int32),
              torch.zeros((2, 16, 4), dtype=torch.int32),
              torch.ones((2, 16, 4)), torch.ones((2, 16))]
    with pytest.raises(ValueError, match="layer_kind 'bogus'"):
        step(model, "1-chain", *arrays)


# --------------------------------------------------------------------- CLI
CLI = ["--device", "cpu", "--embed_dim", "16", "--num_bases", "4",
       "--batch_size", "16", "--n_neg", "4", "--syn_entities", "200",
       "--syn_triples", "800", "--syn_train_queries", "140",
       "--syn_val_queries", "28"]


@pytest.mark.parametrize("parallel", ["halo_ring", "halo_gather"])
def test_train_cli_halo_on_cpu(parallel, tmp_path, capsys):
    import json

    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "run")
    main(CLI + ["--parallel", parallel, "--steps", "6", "--val_every", "3",
                "--run_dir", run])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"final step=6 macro_auc=\S+ macro_apr=\S+", last)
    lines = [json.loads(ln) for ln in open(os.path.join(run,
                                                        "metrics.jsonl"))]
    assert {"event": "mesh", "shape": {"data": 1, "model": 1}}.items() <= \
        next(ln for ln in lines if ln.get("event") == "mesh").items()
    assert {"step_3", "step_6"} <= set(os.listdir(os.path.join(run, "ckpt")))


@pytest.mark.parametrize("flags,exc,msg", [
    (["--parallel", "spmd", "--model", "gqe"], SystemExit,
     "--parallel requires --model rgcn"),
    (["--parallel", "halo_ring", "--kernel", "fused"], SystemExit,
     "single-chip for now"),
    (["--parallel", "halo_gather", "--model", "gqe"], SystemExit,
     "--parallel requires --model rgcn"),
    (["--parallel", "halo_ring", "--shared_negatives", "4"], SystemExit,
     "--shared_negatives is single-chip"),
    (["--parallel", "spmd", "--mesh", "3,1"], ValueError,
     "16 queries do not split into 3 data parts"),
    (["--parallel", "spmd", "--steps_per_call", "4", "--hard_margin",
      "0.5"], ValueError, "hard_margin needs the default train step"),
], ids=["spmd", "kernel", "model", "shared_neg", "mesh", "multistep"])
def test_train_cli_parallel_refusals(flags, exc, msg, tmp_path):
    from mpqe_tpu_torch.train.__main__ import main

    with pytest.raises(exc, match=re.escape(msg)):
        main(CLI + flags + ["--steps", "2", "--run_dir",
                            str(tmp_path / "r")])


@pytest.mark.parametrize("flags,shape", [
    (["--parallel", "spmd"], {"data": 1, "model": 1}),
    (["--parallel", "halo_ring", "--mesh", "2,1"], {"data": 2, "model": 1}),
    (["--parallel", "spmd", "--steps_per_call", "2"],
     {"data": 1, "model": 1}),
], ids=["spmd", "mesh", "multistep"])
def test_train_cli_parallel_flags_on_cpu(flags, shape, tmp_path, capsys):
    """What the refusals above once pinned now trains: ``--parallel spmd``
    (also K steps a call), and under ``--device cpu`` a ``--mesh`` of
    several parts, all on the CPU."""
    import json

    from mpqe_tpu_torch.train.__main__ import main

    run = str(tmp_path / "run")
    main(CLI + flags + ["--steps", "4", "--val_every", "2", "--run_dir",
                        run])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"final step=4 macro_auc=\S+ macro_apr=\S+", last)
    lines = [json.loads(ln) for ln in open(os.path.join(run,
                                                        "metrics.jsonl"))]
    assert next(ln for ln in lines
                if ln.get("event") == "mesh")["shape"] == shape
