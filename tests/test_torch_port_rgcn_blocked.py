"""K6 in the PyTorch port (``mpqe_tpu_torch/ops/rgcn_blocked.py``) against
the JAX package's Pallas kernels ``_messages_blocked_pallas`` (K6a) and
``_grad_blocked_pallas`` (K6b), run here in interpret mode, and the
blocked layer, its gradients and the batch loss (``--kernel blocked``)
against their JAX counterparts.  Inputs come from numpy with a seed,
parameters from the JAX ``init_mpqe``, carried across with
``model_from_numpy``.

Tolerances (max|diff| / max|ref|):
* plain K6a / K6b vs the Pallas kernels: 1e-4.  Same function and
  rounding points (bf16 x, basis and g; f32 sums; each message, each
  weight-gradient term and each ``s_eb`` rounded to bf16); only the order
  of the f32 sums differs (~1e-7).  That noise can round a message (or an
  ``s_eb``) to the neighbouring bf16 value, a flip of 2^-8 of that term.
  The fixed inputs of the first tests have no flip.  The seed sweep holds
  the shape of a flip instead: few output rows beyond 1e-4 (at most 1 in
  10), every row within 1e-2.  Measured at d = 16 over the sweep: K6a and
  dcoeff equal, dbasis within 3e-7 (no flip seen).
* the layer and the batch loss vs JAX's blocked path: 1e-4 on flip-free
  inputs for the layer; the loss and its gradients within 5e-2 of the
  largest value, the JAX package's own bound between its blocked and
  dense paths (tests/test_kernel_path.py), and against the f32 twin
  3e-2 (tests/test_pallas_blocked.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import pallas_rgcn_blocked as jprb
from mpqe_tpu.ops import template_layout as jtl
from mpqe_tpu.queries import STRUCTURES
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import edge_store as tes
from mpqe_tpu_torch.ops import rgcn_blocked as tprb

N_ENT, N_MODES, N_RELS, D = 60, 3, 6, 16


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(nb=3, seed=0, n_layers=2):
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=D,
              n_layers=n_layers, num_bases=nb, readout="tgt")
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _general(seed, n_nodes=40, n_e=160, node_block=16, chunk=8):
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, n_nodes, n_e).astype(np.int32),
         rng.integers(0, n_nodes, n_e).astype(np.int32),
         rng.integers(0, N_RELS, n_e).astype(np.int32))
    st = tes.build_edge_store(*a, n_nodes, N_RELS)
    return tprb.bucket_edges_blocked(st, node_block, chunk), n_nodes


def _template(seed, structure="3-chain_inter", B=16):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    er = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
    en = rng.uniform(0.5, 1.5, spec.n_edges).astype(np.float32)
    bk = jtl.template_blocked(structure, jnp.asarray(er), jnp.asarray(en), B,
                              queries_per_block=8, chunk=8)
    return ({k: (v if isinstance(v, int) else np.asarray(v))
             for k, v in bk.items()}, B * spec.n_nodes)


def _layouts(seed):
    return [("general",) + _general(seed), ("template",) + _template(seed)]


def _kernels(bk, n, seed, params):
    """(port K6a, JAX K6a, port K6b, JAX K6b) on the same inputs."""
    lp = params["layers"][0]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    g = rng.normal(size=(n, D)).astype(np.float32)
    lay = tprb.layout_on(bk, "cpu")
    basis, coeff = _t(np.asarray(lp["basis"])), _t(np.asarray(lp["coeff"]))
    got = tprb.messages_blocked(_t(x), basis, coeff, lay, N_RELS)
    want = jprb._messages_blocked_pallas(jnp.asarray(x), lp["basis"],
                                         lp["coeff"], bk, N_RELS,
                                         interpret=True)
    gdb, gdc = tprb.grad_blocked(_t(x), _t(g), basis, coeff, lay, N_RELS)
    wdb, wdc = jprb._grad_blocked_pallas(jnp.asarray(x), jnp.asarray(g),
                                         lp["basis"], lp["coeff"], bk,
                                         N_RELS, interpret=True)
    return got.numpy(), np.asarray(want), (gdb.numpy(), gdc.numpy()), (
        np.asarray(wdb), np.asarray(wdc))


def test_plain_k6_matches_pallas_interpret():
    _, _, params, _ = _models()
    for name, bk, n in _layouts(1):
        got, want, gg, wg = _kernels(bk, n, 2, params)
        assert got.shape == (n, D)
        assert _rel(got, want) <= 1e-4, (name, _rel(got, want))
        assert _rel(gg[0], wg[0]) <= 1e-4, (name, _rel(gg[0], wg[0]))
        assert _rel(gg[1], wg[1]) <= 1e-4, (name, _rel(gg[1], wg[1]))


@pytest.mark.parametrize("seed", [3, 5, 7, 11])
def test_plain_k6_matches_pallas_interpret_seed_sweep(seed):
    _, _, params, _ = _models(seed=seed)
    for name, bk, n in _layouts(seed):
        got, want, gg, wg = _kernels(bk, n, seed + 1, params)
        rows = np.abs(got - want).max(axis=1) / (np.abs(want).max() + 1e-12)
        assert rows.max() <= 1e-2, (name, rows.max())
        assert (rows > 1e-4).mean() <= 0.1, (name, np.sort(rows)[-5:])
        for a, b in zip(gg, wg):
            assert _rel(a, b) <= 1e-2, (name, _rel(a, b))


def test_k6_layouts_and_first_flags():
    bk, _ = _general(4)
    lay = tprb.layout_on(bk, "cpu", "t_")
    np.testing.assert_array_equal(
        lay["chunk_first"].numpy(),
        np.asarray(jprb._first_flags(jnp.asarray(bk["t_chunk_dst_blk"]))))
    np.testing.assert_array_equal(lay["chunk_first"].numpy(),
                                  bk["t_chunk_first"])
    lo, hi = tprb._dst_block_ranges(tprb.layout_on(bk, "cpu"),
                                    bk["n_blocks"])
    c_dst = bk["chunk_dst_blk"]
    for blk in range(bk["n_blocks"]):
        idx = np.nonzero(c_dst == blk)[0]
        assert (lo[blk], hi[blk]) == (idx.min(), idx.max() + 1)


def test_k6_partition_depends_on_edge_count_only():
    for E in (8, 256, 300, 4096, 1 << 20):
        per, n = tprb._partition(E)
        assert per % tprb.EDGE_TILE == 0 and per * n >= E
        assert per >= tprb.PARTITION_MIN_EDGES
        assert n <= tprb.PARTITIONS_MAX and per * (n - 1) < E


# ---------------------------------------------------------- layer and VJP
@pytest.mark.parametrize("layout", ["general", "template"])
def test_blocked_layer_and_grads_match_jax(layout):
    _, _, params, model = _models()
    bk, n = _general(8) if layout == "general" else _template(8)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(n, D)).astype(np.float32)
    g = rng.normal(size=(n, D)).astype(np.float32)
    lp0 = params["layers"][0]

    def jloss(x, p):
        return jnp.vdot(jprb.rgcn_sparse_blocked(x, p, bk, N_RELS,
                                                 interpret=True), g)

    with jax.default_matmul_precision("highest"):
        jout = jprb.rgcn_sparse_blocked(jnp.asarray(x), lp0, bk, N_RELS,
                                        interpret=True)
        jdx, jdp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), lp0)
        twin = jprb._messages_xla_twin(
            jnp.asarray(x), lp0["basis"], lp0["coeff"],
            *(jnp.asarray(bk[k]) for k in ("src_local", "dst_local", "rel",
                                            "norm", "chunk_src_blk",
                                            "chunk_dst_blk")),
            N_RELS, bk["node_block"], bk["chunk"])
    xt = _t(x).requires_grad_()
    lt = model.layers[0]
    out = tprb.rgcn_sparse_blocked(xt, lt, bk, N_RELS)
    assert _rel(out.detach().numpy(), jout) <= 1e-4
    grads = torch.autograd.grad(out, [xt] + list(lt.parameters()), _t(g))
    assert _rel(grads[0].numpy(), jdx) <= 1e-4
    for (name, _), gr in zip(lt.named_parameters(), grads[1:]):
        assert _rel(gr.numpy(), jdp[name]) <= 1e-4, (layout, name)
    # the port's f32 twin is the JAX one, and K6a holds to it within bf16
    lay = tprb.layout_on(bk, "cpu")
    t_twin = tprb._messages_xla_twin(
        _t(x), lt.basis, lt.coeff, *(lay[k] for k in (
            "src_local", "dst_local", "rel", "norm", "chunk_src_blk",
            "chunk_dst_blk")), N_RELS, bk["node_block"], bk["chunk"])
    assert _rel(t_twin.detach().numpy(), twin) <= 1e-5
    agg = tprb.messages_blocked(_t(x), lt.basis.detach(), lt.coeff.detach(),
                                lay, N_RELS)
    assert _rel(agg.numpy(), twin) <= 3e-2


def test_blocked_refusals():
    _, _, _, full = _models(nb=None)
    _, _, _, basis = _models()
    bk, n = _general(0)
    x = torch.zeros((n, D))
    with pytest.raises(ValueError, match="basis decomposition"):
        tprb.rgcn_sparse_blocked(x, full.layers[0], bk, N_RELS)
    no_t = {k: v for k, v in bk.items() if not k.startswith("t_")}
    with pytest.raises(ValueError, match="transpose"):
        tprb.rgcn_sparse_blocked(x, basis.layers[0], no_t, N_RELS)
    with pytest.raises(ValueError, match="num_bases"):
        tm.dense_batch_loss_kernel_blocked(
            full, full_cfg(), "1-chain", *([None] * 8))


def full_cfg():
    return tm.MPQEConfig(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
                         embed_dim=D, n_layers=2, num_bases=None)


# -------------------------------------------------------------- batch loss
def _batch(structure, seed, B=16, K=3):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_RELS, spec.n_edges).astype(np.int32),
            rng.uniform(0.5, 1.5, spec.n_edges).astype(np.float32),
            rng.integers(0, N_ENT, B).astype(np.int32),
            rng.integers(0, N_ENT, (B, K)).astype(np.int32),
            (rng.random((B, K)) > 0.2).astype(np.float32),
            (np.arange(B) < B - 3).astype(np.float32))


def _named(tree):
    out = {"emb.ent": tree["emb"]["ent"], "emb.var": tree["emb"]["var"]}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            out[f"layers.{i}.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("structure", ["1-chain", "2-chain", "2-inter",
                                       "3-chain_inter"])
def test_kernel_blocked_batch_loss_matches_jax(structure):
    jcfg, tcfg, params, model = _models(n_layers=3, seed=2)
    arrays = _batch(structure, 4)
    with jax.default_matmul_precision("highest"):
        jv, jg = jax.value_and_grad(
            lambda p: jm.dense_batch_loss_kernel_blocked(
                p, jcfg, structure, *map(jnp.asarray, arrays),
                queries_per_block=8, chunk=8, interpret=True))(params)
    tv = tm.dense_batch_loss_kernel_blocked(
        model, tcfg, structure, *map(_t, arrays), queries_per_block=8,
        chunk=8)
    tv_f = float(tv.detach())
    assert abs(tv_f - float(jv)) <= 5e-2 * max(abs(float(jv)), 1.0)
    want = _named(jg)
    got = dict(zip([n for n, _ in model.named_parameters()],
                   torch.autograd.grad(tv, list(model.parameters()),
                                       allow_unused=True)))
    scale = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        gr = np.zeros_like(w) if got[n] is None else got[n].numpy()
        assert np.abs(gr - w).max() <= 5e-2 * scale, (structure, n)
