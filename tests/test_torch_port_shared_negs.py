"""Batch-shared negatives and the single-lookup loss of the port
(``models/mpqe.py dense_batch_loss_shared_negs``,
``make_shared_negs_batch_loss``, ``dense_batch_loss_fused``) and the
embedding lookup with its three backward scatters (``ops/embed.py``)
against the JAX package on the CPU, parameters carried across.

Tolerance: the loss and every parameter gradient within 1e-5 (relative to
the reference's largest element) of JAX's: f32 on both sides with the
highest matmul precision on JAX's, so only sum orders differ.  The
fused-forward encoder takes K1's plain version here and, with the
``pallas`` backward, K2's plain version, against the Pallas kernels in
interpret mode.  The scatters and the lookup's gradient are held to 1e-6
(sums of the same rows in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import embed as jembed
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import embed as tembed
from mpqe_tpu_torch.queries import STRUCTURES

N_ENT, N_MODES, N_RELS, D = 50, 3, 9, 16
TOL = 1e-5


def _models(seed=1):
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=D,
              n_layers=3, num_bases=4)
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    return jcfg, tcfg, params, model_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _jax_named(tree):
    out = {"emb.ent": tree["emb"]["ent"], "emb.var": tree["emb"]["var"]}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            out[f"layers.{i}.{k}"] = v
    for k, v in tree.get("readout", {}).items():
        out[f"readout.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _check(model, tv, jv, jg, label):
    assert abs(float(tv.detach()) - float(jv)) <= TOL * abs(float(jv)), label
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(tv, list(model.parameters()),
                             allow_unused=True)
    want = _jax_named(jg)
    for n, g in zip(names, gs):
        w = want[n]
        got = np.zeros_like(w) if g is None else g.numpy()
        if np.abs(w).max() > 0:
            assert _rel(got, w) <= TOL, (label, n)
        else:
            assert np.abs(got).max() == 0, (label, n)


def _case(structure, B=20, K=12, seed=10, case="plain"):
    """A batch with padded rows (query_mask 0 on the last 3) and the
    shared candidates; ``self_target``: candidate 0 is query 0's target;
    the negatives [B, 4] for the donor draw."""
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    ne = rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32)
    nm = rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32)
    er = rng.integers(0, N_RELS, (spec.n_edges,)).astype(np.int32)
    en = rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(np.float32)
    tgt = rng.integers(0, N_ENT, (B,)).astype(np.int32)
    shared = rng.integers(0, N_ENT, (K,)).astype(np.int32)
    qmask = (np.arange(B) < B - 3).astype(np.float32)
    if case == "self_target":
        shared[0] = tgt[0]
        shared[5] = tgt[7]
    negs = rng.integers(0, N_ENT, (B, 4)).astype(np.int32)
    nmask = np.ones((B, 4), np.float32)
    return ne, nm, er, en, tgt, shared, qmask, negs, nmask


ENCODERS = {"dense": ("dense", "xla"), "fused_fwd_xla": ("fused_fwd", "xla"),
            "fused_fwd_k2": ("fused_fwd", "pallas")}


def _jax_value_and_grad(fn, params, arrays):
    """``jax.value_and_grad`` of ``fn(params, *arrays)``, jitted (one
    compile instead of one per operation), at the highest precision."""
    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.value_and_grad(fn))(
            params, *map(jnp.asarray, arrays))


@pytest.mark.parametrize("tau", [0.0, 0.5])
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_shared_negs_loss_and_grads_match_jax(encoder, tau):
    """Padded rows, and candidates equal to queries' targets, in every
    batch; a one-layer and a three-layer structure."""
    jcfg, tcfg, params, model = _models()
    enc, bwd = ENCODERS[encoder]
    jkw = dict(encoder=enc, fused_block=8, fused_backward=bwd,
               fused_bwd_block=8, interpret=True, self_adv_tau=tau)
    for structure in ("1-chain", "3-inter_chain"):
        ne, nm, er, en, tgt, shared, qmask, _, _ = _case(
            structure, case="self_target")
        arrays = (ne, nm, er, en, tgt, shared, qmask)
        jv, jg = _jax_value_and_grad(
            lambda p, *a: jm.dense_batch_loss_shared_negs(
                p, jcfg, structure, *a, **jkw), params, arrays)
        tv = tm.dense_batch_loss_shared_negs(
            model, tcfg, structure, *map(torch.from_numpy, arrays),
            encoder=enc, fused_backward=bwd, self_adv_tau=tau)
        assert np.isfinite(float(tv.detach()))
        _check(model, tv, jv, jg, (structure, encoder, tau))


@pytest.mark.parametrize("tau", [0.0, 0.5])
@pytest.mark.parametrize("donors", ["live", "all_padding"])
def test_make_shared_negs_batch_loss_matches_jax(donors, tau):
    """The donor draw: a padded donor gives query 0's negative; with
    every query but 0 padded, every candidate is query 0's negative and
    the padded rows' self-adversarial softmax has no live candidate (no
    NaN)."""
    jcfg, tcfg, params, model = _models(seed=2)
    structure = "2-inter"
    ne, nm, er, en, tgt, _, qmask, negs, nmask = _case(structure, seed=4)
    if donors == "all_padding":
        qmask = np.zeros_like(qmask)
        qmask[0] = 1.0
    arrays = (ne, nm, er, en, tgt, negs, nmask, qmask)
    jfn = jm.make_shared_negs_batch_loss(8, self_adv_tau=tau)
    tfn = tm.make_shared_negs_batch_loss(8, self_adv_tau=tau)
    jv, jg = _jax_value_and_grad(
        lambda p, *a: jfn(p, jcfg, structure, *a), params, arrays)
    tv = tfn(model, tcfg, structure, *map(torch.from_numpy, arrays))
    assert np.isfinite(float(tv.detach()))
    _check(model, tv, jv, jg, (donors, tau))
    with pytest.raises(ValueError, match="n_shared"):
        tm.make_shared_negs_batch_loss(0)


def test_shared_negs_padding_only_batch_is_zero_not_nan():
    _, tcfg, _, model = _models()
    ne, nm, er, en, tgt, shared, qmask, _, _ = _case("2-chain")
    for tau in (0.0, 0.5):
        tv = tm.dense_batch_loss_shared_negs(
            model, tcfg, "2-chain", *map(torch.from_numpy,
                                         (ne, nm, er, en, tgt, shared)),
            torch.zeros(20), self_adv_tau=tau)
        gs = torch.autograd.grad(tv, list(model.parameters()),
                                 allow_unused=True)
        assert float(tv.detach()) == 0.0
        assert all(g is None or torch.isfinite(g).all() for g in gs)


# ------------------------------------------------------ scatters, lookup
@pytest.mark.parametrize("which", ["dense", "sorted", "dedup"])
def test_scatters_match_jax(which):
    rng = np.random.default_rng(0)
    n_rows, m, d = 30, 200, 8
    idx = rng.integers(0, n_rows, m).astype(np.int32)
    g = rng.normal(size=(m, d)).astype(np.float32)
    want = np.asarray(getattr(jembed, f"scatter_add_{which}")(
        n_rows, jnp.asarray(idx), jnp.asarray(g)))
    got = tembed.SCATTERS[which](n_rows, torch.from_numpy(idx),
                                 torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # an index past the table is dropped, as JAX's scatter drops it
    idx[:5] = n_rows
    want = np.asarray(getattr(jembed, f"scatter_add_{which}")(
        n_rows, jnp.asarray(idx), jnp.asarray(g)))
    got = tembed.SCATTERS[which](n_rows, torch.from_numpy(idx),
                                 torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["dense", "sorted", "dedup"])
def test_embedding_lookup_and_grad_match_jax(which):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    idx = rng.integers(0, 40, (6, 7)).astype(np.int32)
    cot = rng.normal(size=(6, 7, 8)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: jembed.embedding_lookup(
        t, jnp.asarray(idx), which), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_()
    got = tembed.embedding_lookup(t, torch.from_numpy(idx), which)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    (g,) = torch.autograd.grad(got, [t], torch.from_numpy(cot))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="grad_scatter"):
        tembed.embedding_lookup(t, torch.from_numpy(idx), "bogus")


@pytest.mark.parametrize("which", ["dense", "sorted", "dedup"])
def test_dense_batch_loss_fused_matches_jax(which):
    """Per ``grad_scatter``: JAX's ``dense_batch_loss_fused`` within
    TOL, and the port's own ``dense_batch_loss`` (the same function)."""
    jcfg, tcfg, params, model = _models(seed=3)
    for structure in ("1-chain", "3-chain_inter"):
        ne, nm, er, en, tgt, _, qmask, negs, _ = _case(structure, seed=6)
        nmask = (np.random.default_rng(6).random(negs.shape) > 0.2).astype(
            np.float32)
        arrays = (ne, nm, er, en, tgt, negs, nmask, qmask)
        jv, jg = _jax_value_and_grad(
            lambda p, *a: jm.dense_batch_loss_fused(
                p, jcfg, structure, *a, grad_scatter=which), params, arrays)
        tv = tm.dense_batch_loss_fused(model, tcfg, structure,
                                       *map(torch.from_numpy, arrays),
                                       grad_scatter=which)
        _check(model, tv, jv, jg, (structure, which))
        plain = tm.dense_batch_loss(model, tcfg, structure,
                                    *map(torch.from_numpy, arrays))
        assert abs(float(plain.detach()) - float(tv.detach())) <= 1e-6
