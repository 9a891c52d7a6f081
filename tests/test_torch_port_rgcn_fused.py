"""K5 in the PyTorch port (``mpqe_tpu_torch/ops/rgcn_fused.py``) against
the JAX package's Pallas kernels ``_messages_pallas_basis`` and
``_messages_pallas_wrel``, run here in interpret mode, and the fused
sparse layer, encoder and batch loss (``--kernel fused``) against their
JAX counterparts.  Inputs come from numpy with a seed, parameters from
the JAX ``init_mpqe``, carried across with ``model_from_numpy``.

Tolerances (max|diff| / max|ref|): everything here is f32 on both sides
(the Pallas kernel at ``Precision.HIGHEST``); only the order of the
sums differs, so the messages, layers and encoders agree to 1e-5
(measured ~1e-7), tighter than the JAX package's own 2e-4 / 3e-4 between
its kernel and its XLA path.  The batch loss is held to 2e-4 and its
gradients to 1e-3 of the largest gradient, the JAX package's own bounds
for the kernel path (tests/test_kernel_path.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import edge_store as jes
from mpqe_tpu.ops import pallas_rgcn as jpr
from mpqe_tpu.ops import template_layout as jtl
from mpqe_tpu.queries import STRUCTURE_NAMES, STRUCTURES
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import edge_store as tes
from mpqe_tpu_torch.ops import rgcn_fused as tpr

N_ENT, N_MODES, N_RELS, D = 60, 3, 8, 16
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(nb=3, seed=0, d=D, n_layers=2):
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=d,
              n_layers=n_layers, num_bases=nb, readout="tgt")
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:  # non-zero biases (init is zeros)
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _stores(seed=0, n_nodes=50, n_e=200):
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, n_nodes, n_e).astype(np.int32),
         rng.integers(0, n_nodes, n_e).astype(np.int32),
         rng.integers(0, N_RELS, n_e).astype(np.int32))
    return (jes.build_edge_store(*a, n_nodes, N_RELS),
            tes.build_edge_store(*a, n_nodes, N_RELS))


def _layouts(seed):
    """(name, chunked dict) pairs: a general graph (padded chunks) and a
    template batch."""
    _, ts = _stores(seed)
    rng = np.random.default_rng(seed + 100)
    spec = STRUCTURES["3-chain_inter"]
    er = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
    en = rng.uniform(0.5, 1.5, spec.n_edges).astype(np.float32)
    tpl = {k: (np.asarray(v) if not isinstance(v, int) else v)
           for k, v in jtl.template_chunked(
               "3-chain_inter", jnp.asarray(er), jnp.asarray(en), 16,
               8).items()}
    return [("general", tpr.chunk_by_relation(ts, 8), 50),
            ("template", tpl, 16 * spec.n_nodes)]


# ----------------------------------------------- plain K5 vs Pallas kernel
@pytest.mark.parametrize("gather", [True, False], ids=["gather", "rows"])
@pytest.mark.parametrize("kind", ["K5a", "K5b"])
def test_plain_k5_matches_pallas_interpret(kind, gather):
    _, _, params, _ = _models(nb=3 if kind == "K5a" else None)
    lp = params["layers"][0]
    for name, ch, n in _layouts(1):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(n, D)).astype(np.float32)
        src = ch["src"]
        n_chunks, chunk = len(ch["chunk_rel"]), ch["chunk"]
        # the Pallas kernels take pre-gathered rows; the port's may gather
        xs = x[np.clip(src, 0, n - 1)]
        norm = ch["norm"]
        crel = ch["chunk_rel"]
        if kind == "K5a":
            ce = np.asarray(jpr._masked_chunk_coeff(
                lp["coeff"], jnp.asarray(crel), N_RELS))
            want = jpr._messages_pallas_basis(
                jnp.asarray(xs), lp["basis"], jnp.asarray(ce),
                jnp.asarray(norm), chunk, interpret=True)
            args = (_t(np.asarray(lp["basis"])), _t(ce), _t(norm), chunk)
            fn = tpr.messages_basis
        else:
            rc = np.clip(crel, 0, N_RELS - 1)
            want = jpr._messages_pallas_wrel(
                jnp.asarray(xs), lp["w_rel"], jnp.asarray(rc),
                jnp.asarray(norm), chunk, interpret=True)
            args = (_t(np.asarray(lp["w_rel"])), _t(rc), _t(norm), chunk)
            fn = tpr.messages_wrel
        got = (fn(_t(x), _t(src), *args) if gather
               else fn(_t(xs), None, *args))
        assert got.shape == (n_chunks * chunk, D)
        assert _rel(got.numpy(), want) <= TOL, (name, _rel(got.numpy(),
                                                           want))


def test_k5_combined_weights_follow_basis_order():
    # W = c_0 V_0 + c_1 V_1 + ... with one rounding per product and sum
    rng = np.random.default_rng(3)
    basis = _t(rng.normal(size=(4, 5, 6)).astype(np.float32))
    cc = _t(rng.normal(size=(2, 4)).astype(np.float32))
    w = tpr.combine_basis(basis, cc)
    for c in range(2):
        want = cc[c, 0] * basis[0]
        for b in range(1, 4):
            want = want + cc[c, b] * basis[b]
        assert torch.equal(w[c], want)


# ---------------------------------------------------- layer and gradients
@pytest.mark.parametrize("route", ["basis", "full", "materialized"])
def test_rgcn_sparse_fused_and_grads_match_jax(route, monkeypatch):
    _, _, params, model = _models(nb=None if route == "full" else 3)
    if route == "materialized":  # the table over MAX_BASIS_VMEM_BYTES
        monkeypatch.setattr(jpr, "MAX_BASIS_VMEM_BYTES", 0)
        monkeypatch.setattr(tpr, "MAX_BASIS_VMEM_BYTES", 0)
    js, ts = _stores(4, n_nodes=30, n_e=100)
    jch, tch = jpr.chunk_by_relation(js, 32), tpr.chunk_by_relation(ts, 32)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, D)).astype(np.float32)
    g = rng.normal(size=(30, D)).astype(np.float32)
    lp0 = params["layers"][0]

    def jloss(x, p):
        return jnp.vdot(jpr.rgcn_sparse_fused(x, p, jch, N_RELS,
                                              interpret=True), g)

    with jax.default_matmul_precision("highest"):
        jout = jpr.rgcn_sparse_fused(jnp.asarray(x), lp0, jch, N_RELS,
                                     interpret=True)
        jdx, jdp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), lp0)
    xt = _t(x).requires_grad_()
    lt = model.layers[0]
    out = tpr.rgcn_sparse_fused(xt, lt, tch, N_RELS)
    assert _rel(out.detach().numpy(), jout) <= TOL
    names = [n for n, _ in lt.named_parameters()]
    grads = torch.autograd.grad(out, [xt] + list(lt.parameters()), _t(g))
    assert _rel(grads[0].numpy(), jdx) <= TOL
    for n, gr in zip(names, grads[1:]):
        assert _rel(gr.numpy(), jdp[n]) <= TOL, (route, n)


def test_edge_messages_match_xla_oracle():
    _, _, params, _ = _models()
    lp = params["layers"][0]
    js, ts = _stores(6)
    ch = tpr.chunk_by_relation(ts, 16)
    x = np.random.default_rng(7).normal(size=(50, D)).astype(np.float32)
    args = (_t(ch["src"]), _t(ch["norm"]))
    got = tpr.rgcn_edge_messages(_t(x), _t(np.asarray(lp["basis"])),
                                 _t(np.asarray(lp["coeff"])), *args, N_RELS,
                                 16, _t(ch["chunk_rel"]))
    want = tpr._edge_messages_xla(_t(x), _t(np.asarray(lp["basis"])),
                                  _t(np.asarray(lp["coeff"])), args[0],
                                  args[1], _t(ch["chunk_rel"]), N_RELS, 16)
    with jax.default_matmul_precision("highest"):
        jwant = jpr._edge_messages_xla(
            jnp.asarray(x), lp["basis"], lp["coeff"], jnp.asarray(ch["src"]),
            jnp.asarray(ch["norm"]), jnp.asarray(ch["chunk_rel"]), N_RELS, 16)
    assert _rel(got.detach().numpy(), want.detach().numpy()) <= TOL
    assert _rel(want.detach().numpy(), jwant) <= TOL


def test_encode_sparse_fused_matches_jax():
    jcfg, tcfg, params, model = _models(n_layers=3)
    s = "3-chain_inter"
    spec = STRUCTURES[s]
    rng = np.random.default_rng(8)
    B = 16
    ne = rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32)
    nm = rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32)
    er = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
    en = rng.uniform(0.5, 1.5, spec.n_edges).astype(np.float32)
    jv = jm._sparse_view_on_device(s, jnp.asarray(ne), jnp.asarray(nm))
    tv = tm._sparse_view_on_device(s, _t(ne), _t(nm))
    jch = jtl.template_chunked(s, jnp.asarray(er), jnp.asarray(en), B, 8)
    from mpqe_tpu_torch.ops import template_layout as ttl
    tch = ttl.template_chunked(s, _t(er), _t(en), B, 8)
    with jax.default_matmul_precision("highest"):
        want = jm.encode_sparse_fused(params, jcfg, s, *jv[:3], jch,
                                      *jv[3:5], B, interpret=True)
        want_x = jm.encode_sparse(params, jcfg, s, *jv[:3], jch["src"],
                                  jch["dst"], jnp.repeat(jnp.asarray(er), B),
                                  jch["norm"], *jv[3:5], B)
    with torch.no_grad():
        got = tm.encode_sparse_fused(model, tcfg, s, *tv[:3], tch, *tv[3:5],
                                     B)
    assert got.shape == (B, D)
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(got.numpy(), want_x) <= TOL


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


@pytest.mark.parametrize("nb", [3, None], ids=["basis", "full"])
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_kernel_fused_batch_loss_matches_jax(structure, nb):
    jcfg, tcfg, params, model = _models(nb=nb, n_layers=3, seed=1)
    arrays = _batch(structure, 9)
    with jax.default_matmul_precision("highest"):
        jv, jg = jax.value_and_grad(lambda p: jm.dense_batch_loss_kernel_fused(
            p, jcfg, structure, *map(jnp.asarray, arrays), chunk=8,
            interpret=True))(params)
    tv = tm.dense_batch_loss_kernel_fused(model, tcfg, structure,
                                          *map(_t, arrays), chunk=8)
    tv_f = float(tv.detach())
    assert abs(tv_f - float(jv)) <= 2e-4 * max(abs(float(jv)), 1.0)
    want = _named(jg)
    got = dict(zip([n for n, _ in model.named_parameters()],
                   torch.autograd.grad(tv, list(model.parameters()),
                                       allow_unused=True)))
    scale = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        gr = got[n]
        gr = np.zeros_like(w) if gr is None else gr.numpy()
        assert np.abs(gr - w).max() <= 1e-3 * scale, (structure, n)
