"""The PyTorch port's MPQE model against the JAX package's: the float32
per-query-relation encoder for both layer kinds and every readout, the
K3 routing, and the weight carry-over in both layouts.

Tolerance: port f32 ``encode_dense_multi`` vs JAX f32 (``highest``
matmul precision) within 1e-5 of max|ref| — both are exact-f32 products
with sums in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.data.torch_import import export_mpqe_state_dict
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.queries import STRUCTURE_NAMES, STRUCTURES
from mpqe_tpu_torch import convert
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import fused_fwd as tff

N_ENT, N_MODES, N_RELS, D = 300, 4, 12, 16


def _pair(readout="tgt", num_bases=4, seed=0):
    kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS, embed_dim=D,
              n_layers=3, num_bases=num_bases, readout=readout)
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:  # non-zero biases (init is zeros)
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    for leaf in list(params["readout"]):
        if leaf.startswith("b_"):
            params["readout"][leaf] = jnp.asarray(0.1 * rng.normal(
                size=params["readout"][leaf].shape).astype(np.float32))
    model = convert.model_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     "cpu")
    return jcfg, tcfg, params, model


def _inputs(structure, B=24, seed=0):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_RELS, (B, spec.n_edges)).astype(np.int32),
            rng.uniform(0.5, 1.5, (B, spec.n_edges)).astype(np.float32))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
@pytest.mark.parametrize("readout", ["tgt", "sum", "max", "concat", "mlp"])
@pytest.mark.parametrize("num_bases", [4, None], ids=["basis", "full"])
def test_encode_dense_multi_matches_jax(structure, readout, num_bases):
    jcfg, tcfg, params, model = _pair(readout, num_bases)
    arrays = _inputs(structure)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.encode_dense_multi(
            params, jcfg, structure, *map(jnp.asarray, arrays)))
    with torch.no_grad():
        got = tm.encode_dense_multi(model, tcfg, structure,
                                    *_torch(arrays)).numpy()
    assert got.shape == want.shape == (24, D)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert err <= 1e-5, (structure, readout, num_bases, err)


@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_auto_routes_eligible_models_through_k3(structure):
    _, tcfg, _, model = _pair()
    _, full_cfg, _, full_model = _pair(num_bases=None)
    args = _torch(_inputs(structure, seed=1))
    before = tff.fused_tgt_forward_multi.launches
    ops = tff.prepare_fused_multi(model, tcfg)
    with torch.no_grad():
        assert tm.multi_kernel_eligible(tcfg, structure)
        got = tm.encode_dense_multi_auto(model, tcfg, structure, *args,
                                         operands=ops)
        want = tff.fused_tgt_forward_multi_reference(model, tcfg, structure,
                                                     *args, operands=ops)
        assert torch.equal(got, want)
        # ineligible (full weights): the plain f32 encoder, as in JAX
        assert not tm.multi_kernel_eligible(full_cfg, structure)
        got = tm.encode_dense_multi_auto(full_model, full_cfg, structure,
                                         *args, operands=None)
        want = tm.encode_dense_multi(full_model, full_cfg, structure, *args)
        assert torch.equal(got, want)
    assert tff.fused_tgt_forward_multi.launches == before


@pytest.mark.parametrize("n_modes", [4, 17, 40, 130])
@pytest.mark.parametrize("readout,num_bases", [("tgt", 4), ("tgt", None),
                                               ("sum", 4)])
def test_multi_kernel_eligible_matches_jax(monkeypatch, n_modes, readout,
                                           num_bases):
    # the JAX predicate also refuses the CPU backend; pretend a TPU so
    # that only the model-side conditions are compared
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    kw = dict(n_entities=N_ENT, n_modes=n_modes, n_rels=N_RELS, embed_dim=D,
              n_layers=3, num_bases=num_bases, readout=readout)
    for structure in STRUCTURE_NAMES:
        assert (tm.multi_kernel_eligible(tm.MPQEConfig(**kw), structure)
                == jm.multi_kernel_eligible(jm.MPQEConfig(**kw), structure))


@pytest.mark.parametrize("readout,num_bases", [("tgt", 4), ("mlp", None),
                                               ("concat", 4)])
def test_numpy_round_trip_is_exact(readout, num_bases):
    _, tcfg, params, model = _pair(readout, num_bases)
    back = convert.model_to_numpy(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("readout,num_bases", [("tgt", 4), ("tgt", None),
                                               ("mlp", 4), ("concat", None)])
def test_state_dict_carry_over_is_exact(readout, num_bases):
    _, tcfg, params, _ = _pair(readout, num_bases, seed=3)
    sd = export_mpqe_state_dict(params)
    for as_tensors in (False, True):
        src = ({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
               if as_tensors else sd)
        model = convert.model_from_state_dict(src, tcfg, "cpu")
        back = convert.model_to_numpy(model)
        for a, b in zip(jax.tree.leaves(back),
                        jax.tree.leaves(jax.tree.map(np.asarray, params))):
            np.testing.assert_array_equal(a, b)


def test_carry_over_refuses_mismatched_weights():
    _, tcfg, params, _ = _pair()
    tree = jax.tree.map(np.asarray, params)
    tree["layers"][0]["coeff"] = tree["layers"][0]["coeff"][:-1]
    with pytest.raises(ValueError, match="coeff"):
        convert.model_from_numpy(tree, tcfg, "cpu")
    tree = jax.tree.map(np.asarray, params)
    del tree["layers"][1]["basis"]
    with pytest.raises(ValueError, match="missing"):
        convert.model_from_numpy(tree, tcfg, "cpu")


def test_init_mpqe_names_shapes_and_seed():
    cfg = tm.MPQEConfig(n_entities=50, n_modes=3, n_rels=8, embed_dim=16,
                        n_layers=2, num_bases=4, readout="mlp")
    a = tm.init_mpqe(torch.Generator().manual_seed(7), cfg, device="cpu")
    b = tm.init_mpqe(torch.Generator().manual_seed(7), cfg, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in a.state_dict().items()}
    assert shapes == {
        "emb.ent": (50, 16), "emb.var": (3, 16),
        "layers.0.w_self": (16, 16), "layers.0.bias": (16,),
        "layers.0.basis": (4, 16, 16), "layers.0.coeff": (8, 4),
        "layers.1.w_self": (16, 16), "layers.1.bias": (16,),
        "layers.1.basis": (4, 16, 16), "layers.1.coeff": (8, 4),
        "readout.w_pre": (16, 16), "readout.b_pre": (16,),
        "readout.w_post": (16, 16), "readout.b_post": (16,),
    }
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert float(a.emb.ent.detach().std()) == pytest.approx(16 ** -0.5, rel=0.2)


def test_non_float32_configs_raise():
    # bfloat16 is a model dtype (tests/test_torch_port_bf16.py); any
    # other non-float32 dtype raises
    assert tm.MPQEConfig(n_entities=5, n_modes=2, n_rels=2,
                         dtype=torch.bfloat16).dtype == torch.bfloat16
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="model dtype"):
            tm.MPQEConfig(n_entities=5, n_modes=2, n_rels=2, dtype=dtype)


def test_score_matches_jax():
    jcfg, tcfg, params, model = _pair()
    rng = np.random.default_rng(4)
    q = rng.normal(size=(6, D)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.score_all_entities(params, jcfg, jnp.asarray(q)))
        want_pair = np.asarray(jm.score(jcfg, jnp.asarray(q),
                                        params["emb"]["ent"][:6]))
    with torch.no_grad():
        got = tm.score_all_entities(model, tcfg, torch.from_numpy(q)).numpy()
        got_pair = tm.score(tcfg, torch.from_numpy(q),
                            model.emb.ent[:6]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got_pair, want_pair, atol=1e-6)


def test_plan_helpers_and_relation_weights_match_jax():
    from mpqe_tpu.ops import rgcn as jrgcn
    from mpqe_tpu_torch.ops import rgcn as trgcn

    for readout in ("tgt", "sum"):
        jcfg, tcfg, _, _ = _pair(readout)
        for s in STRUCTURE_NAMES:
            assert tm.num_steps(tcfg, s) == jm.num_steps(jcfg, s)
            assert (tm.anchor_gather_slots(tcfg, s)
                    == jm.anchor_gather_slots(jcfg, s))
            steps = jm.num_steps(jcfg, s)
            assert (tm._live_slot_plan(STRUCTURES[s], steps)
                    == jm._live_slot_plan(STRUCTURES[s], steps))
    rel = np.array([3, 0, 11, 3], np.int32)
    for num_bases in (4, None):
        _, _, params, model = _pair(num_bases=num_bases)
        lp, tl = params["layers"][1], model.layers[1]
        with jax.default_matmul_precision("highest"), torch.no_grad():
            np.testing.assert_allclose(
                trgcn.relation_weights(tl).numpy(),
                np.asarray(jrgcn.relation_weights(lp)), rtol=0, atol=1e-6)
            np.testing.assert_allclose(
                trgcn._edge_weights(tl, torch.from_numpy(rel)).numpy(),
                np.asarray(jrgcn._edge_weights(lp, jnp.asarray(rel))),
                rtol=0, atol=1e-6)
