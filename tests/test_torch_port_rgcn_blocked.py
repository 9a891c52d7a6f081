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
    # K6a's blocks own whole rows: consecutive, every row once, each
    # block's first row where its share of the destination CSR starts
    fwd = tprb.layout_on(bk, "cpu")
    rows, ptr = fwd["cta_rows"].numpy(), fwd["csr_ptr"].numpy()
    assert rows[0] == 0 and rows[-1] == fwd["n_cap"]
    assert (np.diff(rows) >= 0).all()
    E = bk["src_local"].size
    per = min(tprb.K6A_EDGES_PER_BLOCK,
              max(128, -(-E // tprb.K6A_MIN_BLOCKS)))
    assert rows.size - 1 == -(-E // per)
    starts = np.arange(rows.size - 1) * per
    np.testing.assert_array_equal(
        rows[:-1], np.minimum(np.searchsorted(ptr, starts, "left"),
                              fwd["n_cap"]))


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


# ------------------------------------- the kernels' edge lists and gates
def _direction(bk, prefix):
    """One direction of a bucketing as the Pallas kernel takes it."""
    out = {k: bk[prefix + k] for k in tprb.LAYOUT_KEYS}
    for k in ("node_block", "chunk", "n_blocks"):
        out[k] = bk[k]
    return out


def _all_layouts(seed):
    """(name, bucketed, n_nodes, prefix): a general bucketing and
    ``template_blocked``, each in both directions."""
    return [(f"{name}{p or '/'}", bk, n, p) for name, bk, n in
            _layouts(seed) for p in ("", "t_")]


@pytest.mark.parametrize("seed", [0, 6])
def test_k6_edge_lists_follow_the_plain_order(seed):
    """layout_on's destination CSR holds each row's real edges in the
    order ``_ordered_rows_sum`` adds them (stable by edge position), drops
    the padding edges, keeps empty rows; K6b's list keeps edge order."""
    for name, bk, _, p in _all_layouts(seed):
        lay = tprb.layout_on(bk, "cpu", p)
        sb, chunk = bk["node_block"], bk["chunk"]
        n_cap = bk["n_blocks"] * sb
        src_l = np.asarray(bk[p + "src_local"]).astype(np.int64)
        dst_l = np.asarray(bk[p + "dst_local"]).astype(np.int64)
        src = np.repeat(np.asarray(bk[p + "chunk_src_blk"]), chunk) * sb + \
            src_l
        dst = np.repeat(np.asarray(bk[p + "chunk_dst_blk"]), chunk) * sb + \
            dst_l
        real = ((src_l >= 0) & (src_l < sb) & (dst_l >= 0) & (dst_l < sb)
                & (src < n_cap) & (dst < n_cap))
        pos = np.nonzero(real)[0]
        n_real = pos.size
        if not name.startswith("template"):
            assert n_real < src.size, name  # the bucketing pads
        # K6a's CSR: the real edges by destination (stable), then padding
        order = pos[np.argsort(dst[pos], kind="stable")]
        rel_l = np.asarray(bk[p + "rel"])
        norm_bits = np.asarray(bk[p + "norm"], np.float32).view(np.int32)
        rows_of = np.stack([src, dst, rel_l, norm_bits], 1).astype(np.int32)
        csr = lay["csr"].numpy()
        np.testing.assert_array_equal(csr[:n_real], rows_of[order])
        counts = np.bincount(dst[pos], minlength=n_cap)
        np.testing.assert_array_equal(lay["csr_ptr"].numpy(),
                                      np.concatenate([[0],
                                                      np.cumsum(counts)]))
        P, n_part = tprb._partition(src.size)
        if p:  # K6b reads the forward layout only
            assert "edges" not in lay, name
        else:
            # K6b's list: the real edges in edge order, then padding
            assert int(lay["part_ptr"][-1]) == n_real
            np.testing.assert_array_equal(lay["edge_pos"].numpy()[:n_real],
                                          pos)
            np.testing.assert_array_equal(lay["edges"].numpy()[:n_real],
                                          rows_of[pos])
            np.testing.assert_array_equal(
                lay["part_ptr"].numpy(),
                np.searchsorted(pos, np.arange(n_part + 1) * P))
        # the CSR order is the order in which the plain destination sum
        # adds: a row's running sum of distinct powers of two records it
        vals = torch.zeros((src.size, 1), dtype=torch.float64)
        vals[torch.from_numpy(order), 0] = torch.arange(
            order.size, dtype=torch.float64)
        first = tprb._ordered_rows_sum(
            n_cap, torch.from_numpy(dst).clamp(0, n_cap - 1), vals,
            torch.from_numpy(real))
        ptr = lay["csr_ptr"].numpy()
        want = np.where(counts > 0, (ptr[:-1] + ptr[1:] - 1) * counts / 2, 0)
        np.testing.assert_allclose(first[:, 0].numpy(), want)
        if name.startswith("general"):
            assert (counts == 0).any(), name  # empty rows stay rows
        if p:
            continue
        # K6b's dcoeff runs (one relation within one partition), each
        # summed in order and the partitions in order, give the plain
        # version's dcoeff bit for bit
        s_eb = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(src.size, 3)).astype(np.float32))
        dpos = lay["dc_pos"].numpy()
        dpart, drel, dend = lay["dc"].numpy()[:, :3].T
        assert (drel[n_real:] == -1).all()
        part = torch.zeros((n_part, N_RELS, 3))
        for i in range(n_real):
            if i and dend[i - 1] == dend[i]:
                continue  # not the first entry of its run
            run = slice(i, dend[i])
            assert (dpart[run] == dpart[i]).all() and (drel[run] == drel[i]
                                                       ).all()
            assert dend[i] == n_real or (dpart[dend[i]], drel[dend[i]]) != (
                dpart[i], drel[i])
            acc = torch.zeros(3)
            for j in range(i, dend[i]):
                acc = acc + s_eb[dpos[j]]
            assert dpart[i] == dpos[i] // P
            part[dpart[i], drel[i]] = acc
        dcoeff = torch.zeros((N_RELS, 3))
        for q in range(n_part):
            dcoeff = dcoeff + part[q]
        assert torch.equal(dcoeff, tprb._ordered_dcoeff(
            s_eb, _t(bk[p + "rel"]), N_RELS)), name


@pytest.mark.parametrize("seed", [3, 5, 7, 11])
def test_k6a_bound_holds_plain_against_pallas_interpret(seed):
    """The Pallas kernel sums each product and each destination row in
    another order (one-hot matmuls), the kind of difference the tensor
    cores bring: plain K6a, on both layouts, lies within
    ``blocked_error_bound`` of it, and a plain result with one real edge
    removed does not."""
    _, _, params, _ = _models(seed=seed)
    lp = params["layers"][0]
    basis, coeff = _t(np.asarray(lp["basis"])), _t(np.asarray(lp["coeff"]))
    for name, bk, n, p in _all_layouts(seed):
        rng = np.random.default_rng(seed + 2)
        x = rng.normal(size=(n, D)).astype(np.float32)
        w = basis if not p else basis.transpose(1, 2)
        jw = lp["basis"] if not p else jnp.swapaxes(lp["basis"], 1, 2)
        lay = tprb.layout_on(bk, "cpu", p)
        msg = tprb._edge_messages(_t(x), w, coeff, lay, N_RELS)
        plain = tprb._dst_sum(msg, lay, n)
        pallas = _t(np.asarray(jprb._messages_blocked_pallas(
            jnp.asarray(x), jw, lp["coeff"], _direction(bk, p), N_RELS,
            interpret=True)))
        bound = tprb.blocked_error_bound(_t(x), w, coeff, lay, N_RELS, n)
        np.testing.assert_array_equal(
            bound.numpy(), tprb.blocked_error_bound(
                _t(x), w, coeff, lay, N_RELS, n, msg).numpy())
        gate = tprb.k6a_gate(pallas, plain, bound)
        assert gate["ok"], (name, gate)
        real = torch.nonzero(tprb._real_edges(lay, n)[2]).squeeze(1)
        e = int(real[real.numel() // 2])
        cut = tprb._dst_sum(msg.index_fill(0, torch.tensor([e]), 0.0), lay,
                            n)
        assert not tprb.k6a_gate(pallas, cut, bound)["ok"], name


@pytest.mark.parametrize("layout", ["general", "template"])
def test_k6b_gate_and_its_negative_control(layout):
    """``k6b_gate`` passes the plain parts against themselves and against
    the Pallas kernel's dbasis; with every edge of one relation removed
    from the plain version both its dbasis and its dcoeff checks fail."""
    _, _, params, _ = _models(seed=1)
    lp = params["layers"][0]
    basis, coeff = _t(np.asarray(lp["basis"])), _t(np.asarray(lp["coeff"]))
    bk, n = _general(2) if layout == "general" else _template(2)
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(n, D)).astype(np.float32))
    g = _t(rng.normal(size=(n, D)).astype(np.float32))
    lay = tprb.layout_on(bk, "cpu")
    parts = tprb.grad_blocked_reference_parts(x, g, basis, coeff, lay,
                                              N_RELS)
    s_bound = tprb.grad_s_bound(x, g, basis, lay)
    assert s_bound.shape == parts[2].shape and (s_bound >= 0).all()
    assert tprb.k6b_gate(parts, parts, s_bound, lay["rel"], N_RELS)["ok"]
    wdb, _ = jprb._grad_blocked_pallas(jnp.asarray(x.numpy()),
                                       jnp.asarray(g.numpy()), lp["basis"],
                                       lp["coeff"], bk, N_RELS,
                                       interpret=True)
    assert tprb._rel_err(_t(np.asarray(wdb)), parts[0]) <= tprb.TOL_PLAIN
    r = int(lay["edges"][0, 2])
    cut_lay = dict(lay, norm=torch.where(lay["rel"] == r, 0.0,
                                         lay["norm"]))
    cut = tprb.grad_blocked_reference_parts(x, g, basis, coeff, cut_lay,
                                            N_RELS)
    bad = tprb.k6b_gate(parts, cut, s_bound, lay["rel"], N_RELS)
    assert not bad["ok"] and not bad["dbasis_ok"] and not bad["dcoeff_ok"]


def test_k6b_gate_counts_bf16_neighbours():
    """One bf16 step either way is a flip, two are not (unless the
    cancellation bound covers them); +0 and -0 are the same value; the
    flip share is capped."""
    base = torch.tensor([1.0, -1.0, 0.0, 3.0e-3])
    up = torch.nextafter(base.to(torch.bfloat16), torch.tensor(
        [2.0, -2.0, 1.0, 1.0], dtype=torch.bfloat16)).float()
    assert tprb._bf16_steps(up, base).tolist() == [1, 1, 1, 1]
    assert tprb._bf16_steps(torch.tensor([-0.0]), torch.tensor([0.0])) \
        .tolist() == [0]
    two = torch.nextafter(up.to(torch.bfloat16), torch.tensor(
        [2.0, -2.0, 1.0, 1.0], dtype=torch.bfloat16)).float()
    rel = torch.zeros(4, dtype=torch.int32)
    db = (torch.ones(1), torch.zeros(1, 1))

    def gate(s, bound):
        got = (db[0], tprb._ordered_dcoeff(s[:, None], rel, 1), s[:, None])
        want = (db[0], db[1], base[:, None])
        return tprb.k6b_gate(got, want, bound[:, None], rel, 1)

    zero = torch.zeros(4)
    flips = gate(up, zero)
    assert not flips["ok"] and flips["s_flip_share"] == 1.0  # > 1 %
    assert flips["s_beyond_neighbour"] == 0
    assert not gate(two, zero)["dcoeff_ok"]
    assert gate(two, torch.full((4,), 1.0))["s_beyond_neighbour"] == 4


def test_blocked_layer_takes_prebuilt_layouts():
    _, _, _, model = _models()
    bk, n = _general(1)
    x = _t(np.random.default_rng(1).normal(size=(n, D)).astype(np.float32))
    lt = model.layers[0]
    want = tprb.rgcn_sparse_blocked(x, lt, bk, N_RELS)
    got = tprb.rgcn_sparse_blocked(x, lt, tprb.layouts_on(bk, "cpu"),
                                   N_RELS)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unsupported device"):
        tprb.grad_blocked_parts(x, x, lt.basis, lt.coeff,
                                tprb.layout_on(bk, "cpu"), N_RELS)


def _same_layout(a, b, name):
    assert a.keys() == b.keys(), name
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), (name, k)
        else:
            assert a[k] == b[k], (name, k)


@pytest.mark.parametrize("structure,B", [("1-chain", 16), ("3-inter", 32),
                                         ("3-chain_inter", 16)])
def test_template_blocked_layouts_equal_the_generic_build(structure, B):
    """The cached edge orders plus each batch's relations and norms give
    what ``layouts_on(template_blocked(...))`` builds, array for array, and
    ``relabeled`` does the same for a general bucketing with padding."""
    from mpqe_tpu_torch.ops import template_layout as ttl

    ne = STRUCTURES[structure].n_edges
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        er = _t(rng.integers(0, N_RELS, ne).astype(np.int32))
        en = _t(rng.uniform(0.5, 1.5, ne).astype(np.float32))
        got = ttl.template_blocked_layouts(structure, er, en, B,
                                           queries_per_block=8, chunk=8)
        want = tprb.layouts_on(ttl.template_blocked(
            structure, er, en, B, queries_per_block=8, chunk=8), "cpu")
        for g, w, d in zip(got, want, ("", "t_")):
            _same_layout(g, w, (structure, B, seed, d))
    bk, _ = _general(B)
    rng = np.random.default_rng(B)
    rel = rng.integers(0, N_RELS, bk["rel"].size).astype(np.int32)
    norm = rng.uniform(0.5, 1.5, bk["rel"].size).astype(np.float32)
    lay = tprb.layout_on(bk, "cpu")
    _same_layout(tprb.relabeled(lay, _t(rel), _t(norm)),
                 tprb.layout_on(dict(bk, rel=rel, norm=norm), "cpu"),
                 "general")
