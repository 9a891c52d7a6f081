"""The sparse routes of a bf16 model in the PyTorch port against the JAX
package at bf16 on the CPU: ``rgcn_sparse`` / ``rgcn_sparse_relblock``
and ``encode_sparse`` (both segment backends, every readout), the K5 and
K6 encoders and batch losses (``--kernel fused`` with bases and with full
weights, ``--kernel blocked``; the Pallas kernels in interpret mode), the
halo loss (``--parallel halo_ring`` / ``halo_gather``), the plain K8 on
bf16 operands, K5's bf16-row emulation, and the train CLI at ``--dtype
bfloat16`` on each route, its run dir then evaluated per formula through
the sparse encoder.  Inputs come from numpy with a seed, parameters from
the JAX ``init_mpqe`` at bf16 (biases N(0, 0.1), rounded to bf16),
carried across bit for bit by ``convert.model_from_numpy``.

Tolerances (max|diff| / max|ref| unless said otherwise):
* ``rgcn_sparse``, ``rgcn_sparse_relblock``, ``encode_sparse`` and the
  plain K8: f32 results on both sides from the same bf16 values (every
  product exact in f32), only the f32 sum order differs: 1e-5 (measured
  ~1e-7).  ``encode_sparse`` rounds nowhere between layers, as the
  reference's; an encoder that rounds each layer to bf16 is off by a bf16
  step and fails that bound (checked).
* the K5 / K6 encoders, rounded to bf16 after every layer on both sides:
  1e-2 (one bf16 step that the next layers carry; measured 0, bit-equal);
  and held to the f32 twin of the same bf16 values no worse than twice
  JAX's own distance to it plus 1e-3 (the rule of
  ``test_gqe_bf16_loss_and_grads_match_jax``).
* the K5 / K6 batch losses: 1e-5 relative (measured <= 1.2e-7); every
  leaf's gradient bf16, per leaf mean|diff| / mean|ref| <= 2e-3 of JAX's
  (the bound of ``tests/test_torch_port_bf16.py``; measured 0, bit-equal)
  and the twice-JAX's rule against the f32 twin.
* the halo losses: 1e-5 relative (measured <= 1.2e-7); gradients per leaf
  within 1e-2 of JAX's in mean form (measured <= 3.9e-3: JAX's jitted
  backward rounds its bf16 cotangents at other points) and the
  twice-JAX's rule against the f32 twin (measured <= 1.7 x JAX's).
* K5's bf16-row emulation: the two passes the bf16-row kernel keeps give
  the three passes' bits.
* the per-formula evaluation of a bf16 run dir through the sparse
  encoder against the dense encoder: per-structure AUC within 0.05 (the
  dense bf16 encoder rounds each layer, the sparse one keeps f32; their
  scores part by ~1e-3, which can swap a near-tied pair of the 40 that a
  structure has here: measured <= 0.025, one pair).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.ops import pallas_ring as jring
from mpqe_tpu.ops import rgcn as jrgcn
from mpqe_tpu.ops import template_layout as jtl
from mpqe_tpu.parallel import halo_train as jht
from mpqe_tpu.parallel import mesh as jmesh
from mpqe_tpu.queries import STRUCTURE_NAMES, STRUCTURES
from mpqe_tpu_torch import convert
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import edge_store as tes
from mpqe_tpu_torch.ops import rgcn as trgcn
from mpqe_tpu_torch.ops import ring as tring
from mpqe_tpu_torch.ops import template_layout as ttl
from mpqe_tpu_torch.parallel import halo as thalo
from mpqe_tpu_torch.parallel import halo_train as tht
from mpqe_tpu_torch.parallel import mesh as tmesh
from mpqe_tpu_torch.tools import k5_probe

BF16 = torch.bfloat16
N_ENT, N_MODES, N_RELS, D = 50, 3, 8, 16
TOL_F32 = 1e-5
TOL_ENC = 1e-2
TOL_GRAD = 2e-3
TOL_HALO_GRAD = 1e-2
TOL_AUC = 0.05
_CACHE = {}


def _f(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _f(got), _f(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _mean_rel(got, want):
    got, want = _f(got), _f(want)
    return float(np.abs(got - want).mean() / (np.abs(want).mean() + 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(nb=4, readout="tgt"):
    """(JAX bf16 config, port bf16 config, JAX bf16 params, port bf16
    model, its f32 twin: the same values in an f32 model)."""
    key = (nb, readout)
    if key not in _CACHE:
        kw = dict(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
                  embed_dim=D, n_layers=3, num_bases=nb, readout=readout)
        jcfg = jm.MPQEConfig(**kw, dtype=jnp.bfloat16)
        tcfg = tm.MPQEConfig(**kw, dtype=BF16)
        params = jm.init_mpqe(jax.random.PRNGKey(3 + (nb or 0)), jcfg)
        rng = np.random.default_rng(1)
        for lp in params["layers"]:
            lp["bias"] = jnp.asarray(0.1 * rng.normal(
                size=lp["bias"].shape), jnp.bfloat16)
        arrays = jax.tree.map(np.asarray, params)
        model = convert.model_from_numpy(arrays, tcfg, "cpu")
        twin = convert.model_from_numpy(
            jax.tree.map(lambda a: a.astype(np.float32), arrays),
            dataclasses.replace(tcfg, dtype=torch.float32), "cpu")
        _CACHE[key] = (jcfg, tcfg, params, model, twin)
    return _CACHE[key]


def _f32_cfg(tcfg):
    return dataclasses.replace(tcfg, dtype=torch.float32)


def _named(tree):
    out = {"emb.ent": tree["emb"]["ent"], "emb.var": tree["emb"]["var"]}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            out[f"layers.{i}.{k}"] = v
    for k, v in tree.get("readout", {}).items():
        out[f"readout.{k}"] = v
    return out


def _grads(model, loss):
    gs = torch.autograd.grad(loss, list(model.parameters()),
                             allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g)
            for (n, p), g in zip(model.named_parameters(), gs)}


def _check_against_twin(got, jax_got, twin, what):
    """The port's bf16 result no further from the f32 twin than twice
    JAX's bf16 result plus 1e-3 (mean form)."""
    if np.abs(_f(twin)).max() == 0:
        return
    e_port, e_jax = _mean_rel(got, twin), _mean_rel(jax_got, twin)
    assert e_port <= 2 * e_jax + 1e-3, (what, e_port, e_jax)


def _batch(structure, seed, B=8, K=3):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_RELS, spec.n_edges).astype(np.int32),
            rng.uniform(0.5, 1.5, spec.n_edges).astype(np.float32),
            rng.integers(0, N_ENT, B).astype(np.int32),
            rng.integers(0, N_ENT, (B, K)).astype(np.int32),
            (rng.random((B, K)) > 0.2).astype(np.float32),
            (np.arange(B) < B - 2).astype(np.float32))


# ------------------------------------------------ the f32-result layers
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("nb", [4, None], ids=["basis", "full"])
def test_rgcn_sparse_bf16_matches_jax(nb, backend):
    """A bf16 layer on bf16 rows (layer 0) and on f32 rows (every later
    layer of ``encode_sparse``): an f32 result equal to JAX's to sum
    order; the relation-gathered oracle too."""
    params = jrgcn.init_rgcn_layer(jax.random.PRNGKey(2), D, D, N_RELS, nb,
                                   dtype=jnp.bfloat16)
    params["bias"] = jnp.asarray(0.1 * np.random.default_rng(0).normal(
        size=(D,)), jnp.bfloat16)
    layer = convert.layer_from_numpy(jax.tree.map(np.asarray, params),
                                     "cpu")
    assert layer.w_self.dtype == BF16
    rng = np.random.default_rng(4)
    n, e = 40, 160
    ids = [rng.integers(0, n, e), rng.integers(0, n, e),
           rng.integers(0, N_RELS, e)]
    st = tes.build_edge_store(*ids, n, N_RELS)
    edges = (st.src, st.dst, st.rel, st.norm)
    x32 = rng.normal(size=(n, D)).astype(np.float32)
    for x in (jnp.asarray(x32, jnp.bfloat16), jnp.asarray(x32)):
        want = jrgcn.rgcn_sparse(x, params, *map(jnp.asarray, edges),
                                 N_RELS)
        want_rb = jrgcn.rgcn_sparse_relblock(x, params,
                                             *map(jnp.asarray, edges),
                                             N_RELS)
        xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            BF16 if x.dtype == jnp.bfloat16 else torch.float32)
        with torch.no_grad():
            got = trgcn.rgcn_sparse(xt, layer, *map(_t, edges), N_RELS,
                                    segment_backend=backend)
            got_rb = trgcn.rgcn_sparse_relblock(xt, layer, *map(_t, edges),
                                                N_RELS)
        assert want.dtype == jnp.float32
        assert got.dtype == got_rb.dtype == torch.float32
        assert _rel(got, want) <= TOL_F32, (str(x.dtype), _rel(got, want))
        assert _rel(got_rb, want_rb) <= TOL_F32


def _sparse_inputs(structure, B=16, seed=5):
    """The sparse view of a template batch: (JAX arrays, port tensors),
    each ``(node_entity, node_mode, node_is_var, src, dst, rel, norm,
    node_query, target_node)``."""
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    ne = rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32)
    nm = rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32)
    er = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
    en = rng.uniform(0.5, 1.5, spec.n_edges).astype(np.float32)
    jv = jm._sparse_view_on_device(structure, jnp.asarray(ne),
                                   jnp.asarray(nm))
    ch = jtl.template_chunked(structure, jnp.asarray(er), jnp.asarray(en),
                              B, 8)
    rel = jnp.repeat(jnp.asarray(er), B)
    jargs = (*jv[:3], ch["src"], ch["dst"], rel, ch["norm"], *jv[3:5])
    targs = tuple(_t(np.asarray(a)) for a in jargs)
    return jargs, targs, (ne, nm, er, en)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("readout", ["tgt", "sum", "max", "concat", "mlp"])
def test_encode_sparse_bf16_matches_jax(readout, backend):
    """f32 query vectors, as the reference's (no rounding between
    layers); an encoder that rounds every layer to bf16 fails the bound."""
    jcfg, tcfg, params, model, _ = _models(4, readout)
    for structure in ("3-chain_inter", "2-inter", "3-chain"):
        jargs, targs, _ = _sparse_inputs(structure)
        B = targs[-1].shape[0]
        want = jm.encode_sparse(params, jcfg, structure, *jargs, B)
        with torch.no_grad():
            got = tm.encode_sparse(model, tcfg, structure, *targs, B,
                                   segment_backend=backend)
            rounded = tm._sparse_encode(
                model, tcfg, structure, *targs[:3], *targs[7:9], B,
                lambda x, lp: trgcn.rgcn_sparse(
                    x, lp, *targs[3:7], N_RELS).to(BF16))
        assert want.dtype == jnp.float32 and got.dtype == torch.float32
        assert _rel(got, want) <= TOL_F32, (structure, _rel(got, want))
        assert _rel(rounded, want) > TOL_F32, (structure,
                                               _rel(rounded, want))


# ------------------------------------------------ the K5 and K6 encoders
@pytest.mark.parametrize("route", ["fused_basis", "fused_full", "blocked"])
def test_kernel_encoders_bf16_match_jax(route):
    nb = None if route == "fused_full" else 4
    jcfg, tcfg, params, model, twin = _models(nb)
    for structure in ("3-chain_inter", "2-chain"):
        jargs, targs, (ne, nm, er, en) = _sparse_inputs(structure, seed=6)
        B = ne.shape[0]
        if route == "blocked":
            jlay = jtl.template_blocked(structure, jnp.asarray(er),
                                        jnp.asarray(en), B,
                                        queries_per_block=8, chunk=8)
            tlay = ttl.template_blocked_layouts(
                structure, _t(er), _t(en), B, queries_per_block=8, chunk=8)
            want = jm.encode_sparse_blocked(params, jcfg, structure,
                                            *jargs[:3], jlay, *jargs[7:9],
                                            B, interpret=True)
            with torch.no_grad():
                got = tm.encode_sparse_blocked(model, tcfg, structure,
                                               *targs[:3], tlay,
                                               *targs[7:9], B)
                got32 = tm.encode_sparse_blocked(twin, _f32_cfg(tcfg),
                                                 structure, *targs[:3],
                                                 tlay, *targs[7:9], B)
        else:
            jch = jtl.template_chunked(structure, jnp.asarray(er),
                                       jnp.asarray(en), B, 8)
            tch = ttl.template_chunked(structure, _t(er), _t(en), B, 8)
            want = jm.encode_sparse_fused(params, jcfg, structure,
                                          *jargs[:3], jch, *jargs[7:9], B,
                                          interpret=True)
            with torch.no_grad():
                got = tm.encode_sparse_fused(model, tcfg, structure,
                                             *targs[:3], tch, *targs[7:9],
                                             B)
                got32 = tm.encode_sparse_fused(twin, _f32_cfg(tcfg),
                                               structure, *targs[:3], tch,
                                               *targs[7:9], B)
        assert want.dtype == jnp.bfloat16 and got.dtype == BF16
        assert _rel(got, want) <= TOL_ENC, (structure, _rel(got, want))
        _check_against_twin(got, want, got32, structure)


@pytest.mark.parametrize("route", ["fused_basis", "fused_full", "blocked"])
@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_kernel_batch_loss_bf16_matches_jax(structure, route):
    """The ``--kernel fused`` / ``blocked`` loss of a bf16 model and every
    leaf's gradient, in bf16, against JAX's (Pallas in interpret mode)."""
    nb = None if route == "fused_full" else 4
    jcfg, tcfg, params, model, twin = _models(nb)
    arrays = _batch(structure, 9)
    if route == "blocked":
        kw = dict(queries_per_block=8, chunk=8)
        jfn, tfn = (jm.dense_batch_loss_kernel_blocked,
                    tm.dense_batch_loss_kernel_blocked)
    else:
        kw = dict(chunk=8)
        jfn, tfn = (jm.dense_batch_loss_kernel_fused,
                    tm.dense_batch_loss_kernel_fused)
    jv, jg = jax.value_and_grad(lambda p: jfn(
        p, jcfg, structure, *map(jnp.asarray, arrays), interpret=True,
        **kw))(params)
    loss = tfn(model, tcfg, structure, *map(_t, arrays), **kw)
    tg = _grads(model, loss)
    loss32 = tfn(twin, _f32_cfg(tcfg), structure, *map(_t, arrays), **kw)
    tg32 = _grads(twin, loss32)
    assert loss.dtype == torch.float32
    lv = float(loss.detach())
    assert abs(lv - float(jv)) <= TOL_F32 * abs(float(jv))
    jgn = _named(jg)
    assert set(jgn) == set(tg)
    for name, want in jgn.items():
        got = tg[name]
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16, name
        if np.abs(_f(want)).max() == 0:
            assert not np.abs(_f(got)).any(), name
            continue
        assert _mean_rel(got, want) <= TOL_GRAD, (name,
                                                  _mean_rel(got, want))
        _check_against_twin(got, want, tg32[name], name)


# -------------------------------------------------------------- halo
@pytest.mark.parametrize("kind", ["ring", "gather"])
def test_halo_loss_bf16_matches_jax(kind):
    """The halo loss of a bf16 model on 4 parts (the port's on ``["cpu"]
    * 4``, JAX's ``shard_map`` layers on 4 of the conftest's CPU devices,
    jitted): loss and every leaf's gradient, in bf16, for 7 structures."""
    jcfg, tcfg, params, model, twin = _models(4)
    jmesh4 = jmesh.make_mesh((4, 1), devices=jax.devices()[:4])
    tmesh4 = tmesh.make_mesh((4, 1), devices=["cpu"] * 4)
    for structure in STRUCTURE_NAMES:
        arrays = _batch(structure, 10)
        jv, jg = jax.jit(jax.value_and_grad(
            lambda p: jht.halo_dense_batch_loss(
                p, jcfg, jmesh4, kind, structure,
                *map(jnp.asarray, arrays))))(params)
        loss = tht.halo_dense_batch_loss(model, tcfg, tmesh4, kind,
                                         structure, *map(_t, arrays))
        tg = _grads(model, loss)
        tg32 = _grads(twin, tht.halo_dense_batch_loss(
            twin, _f32_cfg(tcfg), tmesh4, kind, structure,
            *map(_t, arrays)))
        lv = float(loss.detach())
        assert abs(lv - float(jv)) <= TOL_F32 * abs(float(jv))
        for name, want in _named(jg).items():
            got = tg[name]
            assert got.dtype == BF16, name
            if np.abs(_f(want)).max() == 0:
                continue
            assert _mean_rel(got, want) <= TOL_HALO_GRAD, (
                structure, name, _mean_rel(got, want))
            _check_against_twin(got, want, tg32[name], (structure, name))


def test_plain_k8_bf16_matches_pallas_interpret():
    """K8 on a bf16 layer and bf16 rows: every operand taken up to f32, as
    the reference's kernel takes it; equal to K8 on the widened operands
    and to the Pallas kernel to sum order."""
    from jax.sharding import Mesh

    params = jrgcn.init_rgcn_layer(jax.random.PRNGKey(7), D, D, N_RELS, 3,
                                   dtype=jnp.bfloat16)
    params["bias"] = jnp.asarray(0.1 * np.random.default_rng(1).normal(
        size=(D,)), jnp.bfloat16)
    layer = convert.layer_from_numpy(jax.tree.map(np.asarray, params),
                                     "cpu")
    layer32 = convert.layer_from_numpy(
        {k: np.asarray(v).astype(np.float32) for k, v in params.items()},
        "cpu")
    rng = np.random.default_rng(2)
    n, e = 48, 200
    st = tes.build_edge_store(rng.integers(0, n, e), rng.integers(0, n, e),
                              rng.integers(0, N_RELS, e), n, N_RELS)
    pr = thalo.partition_edges_ring(st, 4)
    x = jnp.asarray(rng.normal(size=(pr.n_nodes_padded, D)), jnp.bfloat16)
    edges = (pr.src_local, pr.dst_local, pr.rel, pr.norm)
    jmesh4 = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    want = jring.rgcn_ring_halo_rdma(jmesh4, params, x,
                                     *map(jnp.asarray, edges), N_RELS,
                                     interpret=True)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16)
    ring4 = tmesh.make_mesh((4, 1), devices=["cpu"] * 4)
    with torch.no_grad():
        got = tring.rgcn_ring_halo_rdma(ring4, layer, xt, *map(_t, edges),
                                        N_RELS)
        widened = tring.rgcn_ring_halo_rdma(ring4, layer32, xt.float(),
                                            *map(_t, edges), N_RELS)
    assert got.dtype == torch.float32
    assert torch.equal(got, widened)
    assert _rel(got, want) <= TOL_F32


# ------------------------------------------------ K5's bf16-row product
@pytest.mark.parametrize("layout", ["template", "general"])
@pytest.mark.parametrize("d", [16, 128, 200])
def test_k5_bf16_rows_two_passes_equal_three(d, layout):
    """The bf16-row kernel's two split-TF32 passes against all three on
    the same bf16 rows (``tools/k5_probe.py emulated_messages``): the same
    bits, within K5's gates."""
    for r in k5_probe.emulate_bf16_case(d, layout, seed=1):
        assert r["bit_equal"]
        assert r["2x_vs_oracle"] <= 1e-5 and r["2x_vs_plain"] <= 1e-4


def test_k5_wrappers_take_bf16_rows_on_the_cpu():
    """On CPU tensors the K5 wrappers take bf16 rows and give the plain
    version on ``x.float()``, bit for bit."""
    from mpqe_tpu_torch.ops import rgcn_fused as trf

    rng = np.random.default_rng(3)
    n, R, chunk = 30, 5, 8
    st = tes.build_edge_store(rng.integers(0, n, 60), rng.integers(0, n, 60),
                              rng.integers(0, R, 60), n, R)
    ch = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in trf.chunk_by_relation(st, chunk).items()}
    src, norm, crel = ch["src"], ch["norm"], ch["chunk_rel"]
    x = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)).to(BF16)
    basis = torch.from_numpy(rng.normal(size=(3, D, D)).astype(np.float32))
    coeff = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    w_rel = torch.einsum("rb,bio->rio", coeff, basis)
    for fn, args in ((trf.messages_basis, (basis, coeff, crel, R)),
                     (trf.messages_wrel, (w_rel, crel.clamp(0, R - 1)))):
        got = fn(x, src, *args, norm, chunk)
        want = fn(x.float(), src, *args, norm, chunk)
        assert got.dtype == torch.float32 and torch.equal(got, want)


# --------------------------------------------------------------- CLIs
class SparseEncode:
    """``evaluate``'s ``encode_fn`` through ``encode_sparse``:
    ``dense_to_sparse`` of the formula's batch, then the ``"pallas"``
    segment backend (the plain K4 here)."""

    def __call__(self, model, cfg, structure, ne, nm, er, en):
        from mpqe_tpu_torch.data import batcher as tbatch

        B = ne.shape[0]
        z = np.zeros(B, np.int32)
        b = tbatch.DenseQueryBatch(
            structure, B, *(t.cpu().numpy() for t in (ne, nm, er, en)), z,
            z[:, None], np.ones((B, 1), np.float32), np.ones(B, np.float32))
        sb = tbatch.dense_to_sparse(b, cfg.n_rels)
        e = sb.edges
        return tm.encode_sparse(
            model, cfg, structure, *(torch.from_numpy(a) for a in (
                sb.node_entity, sb.node_mode, sb.node_is_var, e.src, e.dst,
                e.rel, e.norm, sb.node_query, sb.target_node)), B,
            segment_backend="pallas")


CLI_ROUTES = {
    "fused": ["--kernel", "fused", "--num_bases", "4"],
    "blocked": ["--kernel", "blocked", "--num_bases", "4"],
    "halo_ring": ["--parallel", "halo_ring", "--num_bases", "4"],
}


@pytest.mark.parametrize("route", list(CLI_ROUTES))
def test_train_cli_bf16_sparse_routes_then_evaluate_sparse(route, tmp_path,
                                                          capsys):
    """``python -m mpqe_tpu_torch.train --dtype bfloat16`` on each sparse
    route: bf16 leaves and Adam moments, finite losses and validation;
    then the run dir evaluated per formula through the sparse encoder,
    within TOL_AUC of the dense encoder per structure."""
    from mpqe_tpu_torch import evaluate as eval_cli
    from mpqe_tpu_torch.train import evaluation
    from mpqe_tpu_torch.train.__main__ import main

    run_dir = str(tmp_path / route)
    state = main(["--device", "cpu", "--data", "synthetic", "--embed_dim",
                  "16", "--steps", "12", "--val_every", "6", "--batch_size",
                  "16", "--n_neg", "4", "--syn_entities", "150",
                  "--syn_triples", "400", "--syn_train_queries", "140",
                  "--syn_val_queries", "35", "--dtype", "bfloat16",
                  *CLI_ROUTES[route], "--run_dir", run_dir])
    assert state.step == 12
    assert all(p.dtype == BF16 for p in state.model.parameters())
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        assert st["mu"].dtype == st["nu"].dtype == BF16
    recs = [json.loads(ln) for ln in open(os.path.join(run_dir,
                                                       "metrics.jsonl"))]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert [r for r in recs if "val" in r]
    capsys.readouterr()

    run_cfg, mc = eval_cli.read_run_dir(run_dir)
    cfg = eval_cli.config_from_json(mc)
    assert cfg.dtype == BF16
    _, val_q = eval_cli.load_run_data(run_cfg, "val")
    _, step, model = eval_cli.restore_model(run_dir, cfg, None, "cpu")
    assert step == 12
    sparse = evaluation.evaluate(model, cfg, val_q, n_neg=16,
                                 encode_fn=SparseEncode())
    dense = evaluation.evaluate(model, cfg, val_q, n_neg=16)
    assert set(sparse.auc_by_structure) == set(dense.auc_by_structure)
    for s, a in sparse.auc_by_structure.items():
        assert np.isfinite(a)
        assert abs(a - dense.auc_by_structure[s]) <= TOL_AUC, (
            s, a, dense.auc_by_structure[s])
