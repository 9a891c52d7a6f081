"""The CUDA kernels K1, K2, K3, K4a, K4b, K5a, K5b, K6a, K6b, K7, K8,
the served path and the sparse encoder on the card, against their plain
versions, and the GQE baselines (no kernel) on the card against the
same on the CPU.  Needs an NVIDIA GPU: every test
here skips itself without one.

This file imports no JAX (the machine with the card has none), so it
runs there without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerance: each kernel output vs its plain version max|diff| / max|ref|
<= 1e-4 (for K2 per output leaf); where both sum in the same order the
expected difference is 0 (K7 is held to be bit-equal).  K1, K2 and K3
take their products on the tensor cores and are held to
``ops/fused_fwd.py chain_gate`` (K3 to ``multi_gate``: that on its
output, and each layer from its own activations), with negative
controls that fail it and bit-equal repeats; K1's ``out_bf16`` output
is its own f32 output rounded to bf16, bit for bit, and its
``fold_bias`` is held to ``chain_gate`` with the folded bias row's
control failing it.  K5a and K5b take their products on the tensor
cores in split TF32 (expected ~2e-6), each with a negative control that
fails the gate and a bit-equal repeat.  K6a and K6b take their products
on the tensor cores and are held to the stated bounds of
``ops/rgcn_blocked.py`` (``k6a_gate``, ``k6b_gate``) instead, at the
flagship width and at the wide widths (K5 at K = 768, K6 at d = 256 and
512 with 16 bases).  K4b's maxima are exact: equal, NaN included; K8
(its products in split TF32 through K5's kernel) is held to
``ops/ring.py ring_gate``, K5's gates, with two negative controls that
fail it and bit-equal repeats.  On bf16 operands: K5 on bf16 rows
bit-equal to K5 on their f32 widening (including widths that are not
multiples of 8), the blocked layer with bf16 leaves equal to f32 leaves
of the same values (gradients rounded), K8 on a bf16 layer and rows
equal to K8 on the widened operands.  The root tools' ports:
``kernel_smoke`` (every kernel against its oracles) and one tool of
each group exit 0 on the card with device times recorded.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.ops import fused_fwd as tff
from mpqe_tpu_torch.queries import STRUCTURE_NAMES, STRUCTURES

N_ENT, N_MODES, N_RELS = 5000, 4, 266


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(d, nb, dev, seed=0):
    cfg = tm.MPQEConfig(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
                        embed_dim=d, n_layers=3, num_bases=nb)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = tm.init_mpqe(gen, cfg, device=dev)
    with torch.no_grad():
        for lp in model.layers:
            lp.bias.normal_(0.0, 0.1, generator=gen)
    return cfg, model


def _inputs(structure, B, dev, seed=0):
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
              rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
              rng.integers(0, N_RELS, (B, spec.n_edges)).astype(np.int32),
              rng.uniform(0.5, 1.5, (B, spec.n_edges)).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("d,nb", [(128, 16), (16, 4), (160, 3), (400, 2)],
                         ids=["flagship", "narrow", "dpad256", "dpad512"])
def test_cuda_kernel_matches_plain_version(d, nb):
    """K3 under ``multi_gate`` (its products run on the tensor cores)
    against its plain version for every structure and batch: the output
    under ``chain_gate`` and each layer against the plain layer from the
    kernel's own activations; a repeat launch through the serving path
    bit-equal to the launch that keeps the activations, one counted
    launch per layer, and both controls of ``multi_gate_controls`` on
    query 0 failing the gate at every width."""
    dev = _cuda()
    cfg, model = _model(d, nb, dev)
    ops = tff.prepare_fused_multi(model, cfg)
    for structure in STRUCTURE_NAMES:
        L = tm.num_steps(cfg, structure)
        for B in (1, 20, 1000):
            args = _inputs(structure, B, dev, seed=B)
            before = tff.fused_tgt_forward_multi.launches
            with torch.no_grad():
                got, acts = tff.fused_tgt_forward_multi_layers(
                    model, cfg, structure, *args, operands=ops)
                again = tff.fused_tgt_forward_multi(model, cfg, structure,
                                                    *args, operands=ops)
                gate = tff.multi_gate(cfg, structure, ops, args, got, acts)
                controls = [
                    (name, tff.multi_gate(cfg, structure, o2,
                                          (ne, args[1], er, args[3]), got,
                                          acts))
                    for name, o2, ne, er in tff.multi_gate_controls(
                        cfg, structure, ops, args[0], args[2])]
            torch.cuda.synchronize()
            assert tff.fused_tgt_forward_multi.launches == before + 2 * L
            assert got.shape == (B, d) and got.device.type == "cuda"
            assert torch.equal(got, again), (structure, B)
            assert gate["ok"], (structure, B, gate)
            for name, c in controls:
                assert not c["ok"], (structure, B, name, c)


@pytest.mark.cuda
def test_cuda_wrapper_checks_its_inputs():
    dev = _cuda()
    cfg, model = _model(16, 4, dev)
    ops = tff.prepare_fused_multi(model, cfg)
    ne, nm, er, en = _inputs("2-chain", 8, dev)
    bad = [
        (ne.long(), nm, er, en),  # wrong dtype
        (ne, nm, er, en.double()),
        (ne.t().contiguous().t(), nm, er, en),  # not contiguous
        (ne, nm[:, :2], er, en),  # wrong shape
        (ne, nm.cpu(), er, en),  # mixed devices
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tff.fused_tgt_forward_multi(model, cfg, "2-chain", *args,
                                        operands=ops)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_a_width_over_shared_memory():
    dev = _cuda()
    # d_pad 2048: 3-chain's second layer multiplies the rows of 3 slots,
    # 3 x 16 x (2048 + 8) bf16 (~193 KB) beside the weight stages
    cfg, model = _model(2000, 1, dev)
    ops = tff.prepare_fused_multi(model, cfg)
    before = tff.fused_tgt_forward_multi.launches
    with pytest.raises(ValueError, match="shared memory"):
        tff.fused_tgt_forward_multi(model, cfg, "3-chain",
                                    *_inputs("3-chain", 8, dev), operands=ops)
    assert tff.fused_tgt_forward_multi.launches == before


@pytest.mark.cuda
def test_cuda_server_matches_plain_recomputation():
    from mpqe_tpu_torch.data.sampler import QuerySampler, make_random_kg
    from mpqe_tpu_torch.serve import QueryServer, top_k

    dev = _cuda()
    kg = make_random_kg(n_entities=N_ENT, n_modes=N_MODES, n_base_rels=133,
                        n_triples=20000, seed=0)
    cfg, model = _model(128, 16, dev)
    sampler = QuerySampler(kg, seed=1)
    queries = [q for s in STRUCTURE_NAMES
               for q in sampler.sample_queries(s, 20, n_neg=1)]
    server = QueryServer(model, cfg, kg.entity_mode, device=dev)
    before = tff.fused_tgt_forward_multi.launches
    answers = server.answer(queries)
    assert tff.fused_tgt_forward_multi.launches == before + sum(
        tm.num_steps(cfg, s) for s in STRUCTURE_NAMES)  # one per layer
    for s in STRUCTURE_NAMES:
        idx = [i for i, q in enumerate(queries) if q.formula.structure == s]
        _, *arrays = server._pack([queries[i] for i in idx])
        ne, nm, er, en, tgt_mode = [torch.from_numpy(a).to(dev)
                                    for a in arrays]
        with torch.no_grad():
            # the serving layers, recomputed from the kernel's own vectors
            qk, acts = tff.fused_tgt_forward_multi_layers(
                model, cfg, s, ne, nm, er, en, operands=server._k3)
            q = tm._l2_normalize(qk)
            scores = q @ server._ent_norm_t
            scores.masked_fill_(server._mode_dev[None, :] != tgt_mode[:, None],
                                float("-inf"))
            vals, ids = top_k(scores, 10)
            # the kernel's vectors, within K3's gate of the plain version
            gate = tff.multi_gate(cfg, s, server._k3, (ne, nm, er, en), qk,
                                  acts)
        assert gate["ok"], (s, gate)
        for row, i in enumerate(idx):
            np.testing.assert_array_equal(answers[i].entity_ids,
                                          ids[row].cpu().numpy())
            np.testing.assert_allclose(answers[i].scores,
                                       vals[row].cpu().numpy(), rtol=0,
                                       atol=1e-6)


def _rel(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def _shared_inputs(structure, B, dev, seed=0):
    """One formula's batch: per-query entities and modes, shared
    relations and norms, and an output cotangent."""
    spec = STRUCTURES[structure]
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
              rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
              rng.integers(0, N_RELS, (spec.n_edges,)).astype(np.int32),
              rng.uniform(0.5, 1.5, (spec.n_edges,)).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("d,nb", [(128, 16), (16, 4)],
                         ids=["flagship", "narrow"])
def test_cuda_k1_k2_match_plain_versions(d, nb):
    """K1/K2 under ``chain_gate`` against their plain versions (their
    products run on the tensor cores): every structure and batch, a
    repeat launch bit-equal, both negative controls failing the gate, one
    counted launch per call."""
    dev = _cuda()
    cfg, model = _model(d, nb, dev)
    for structure in STRUCTURE_NAMES:
        blocks = tff.chain_blocks(cfg, structure)
        L = len(blocks.ks)
        for B in (1, 20, 1000, 5000):
            args = _shared_inputs(structure, B, dev, seed=B)
            g = torch.randn((B, d), device=dev,
                            generator=torch.Generator(dev).manual_seed(B))
            with torch.no_grad():
                v_slots, dp, cols, Ws, bs = tff._assemble(
                    model, cfg, structure, *args, None)
                x0 = tff._layer0_operand(cols, args[1], v_slots, cfg, dp)
                ws = [W.to(torch.bfloat16).contiguous() for W in Ws]
                bs = [b.contiguous() for b in bs]
            n_a = len(cols)
            f0, b0 = tff.fused_tgt_forward.launches, \
                tff.fused_tgt_backward.launches
            got = tff._chain_forward(x0, ws, bs, d, blocks)
            kb = tff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)
            again = tff._chain_forward(x0, ws, bs, d, blocks)
            kb2 = tff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)
            torch.cuda.synchronize()
            assert tff.fused_tgt_forward.launches == f0 + 2
            assert tff.fused_tgt_backward.launches == b0 + 2
            assert got.shape == (B, d) and got.device.type == "cuda"
            assert torch.equal(got, again), (structure, B)
            for a, b in zip([kb[0], *kb[1], *kb[2]],
                            [kb2[0], *kb2[1], *kb2[2]]):
                assert torch.equal(a, b), (structure, B)
            plain = tff._chain_forward_plain(x0, ws, bs, d)
            pb = tff._chain_backward_plain(x0, ws, bs, g, n_a, d, dp)
            gf = tff.chain_gate(got, plain, L)
            gb = tff.chain_gate(kb, pb, L, blocks)
            assert gf["ok"], (structure, B, gf)
            assert gb["ok"], (structure, B, gb)
            if B > 1000:
                # one query of 5,000 moves the gradients' statistics by
                # ~1/sqrt(B): below what the gate resolves (derived and
                # checked at B <= 1,000)
                continue
            for name, x, w in tff.chain_gate_controls(x0, ws, blocks, n_a,
                                                      d):
                cf = tff.chain_gate(got, tff._chain_forward_plain(
                    x, w, bs, d), L)
                cb = tff.chain_gate(kb, tff._chain_backward_plain(
                    x, w, bs, g, n_a, d, dp), L, blocks)
                assert not cf["ok"], (structure, B, name, cf)
                assert not cb["ok"], (structure, B, name, cb)


def _chain(model, cfg, structure, args, fold_bias=False):
    with torch.no_grad():
        v_slots, dp, cols, Ws, bs = tff._assemble(
            model, cfg, structure, *args, None, fold_bias=fold_bias)
        x0 = tff._layer0_operand(cols, args[1], v_slots, cfg, dp,
                                 fold_bias=fold_bias)
        ws = [W.to(torch.bfloat16).contiguous() for W in Ws]
        bs = [b.contiguous() for b in bs]
    return x0, ws, bs, len(cols), dp, len(v_slots)


@pytest.mark.cuda
@pytest.mark.parametrize("d,nb", [(128, 16), (16, 4)],
                         ids=["flagship", "narrow"])
def test_cuda_k1_variants_match_plain_versions(d, nb):
    """K1's ``out_bf16``: its bf16 output is K1's own f32 output rounded
    to bf16, bit for bit; ``fold_bias`` (nonzero biases): under
    ``chain_gate`` against its plain version, its control (the folded
    bias row zeroed in the plain version) failing it; each repeat launch
    bit-equal, each launch counted."""
    dev = _cuda()
    cfg, model = _model(d, nb, dev)
    bf16 = torch.bfloat16
    for structure in STRUCTURE_NAMES:
        blocks = tff.chain_blocks(cfg, structure)
        fblocks = tff.chain_blocks(cfg, structure, fold_bias=True)
        L = len(blocks.ks)
        for B in (1, 20, 1000):
            args = _shared_inputs(structure, B, dev, seed=B)
            x0, ws, bs, _, _, _ = _chain(model, cfg, structure, args)
            fx0, fws, fbs, n_a, dp, n_v = _chain(model, cfg, structure, args,
                                                 fold_bias=True)
            f0 = tff.fused_tgt_forward.launches
            got = tff._chain_forward(x0, ws, bs, d, blocks)
            ob = tff._chain_forward(x0, ws, bs, d, blocks, bf16)
            ob2 = tff._chain_forward(x0, ws, bs, d, blocks, bf16)
            fk = tff._chain_forward(fx0, fws, fbs, d, fblocks)
            fk2 = tff._chain_forward(fx0, fws, fbs, d, fblocks)
            torch.cuda.synchronize()
            assert tff.fused_tgt_forward.launches == f0 + 5
            assert ob.dtype == bf16 and ob.shape == (B, d)
            assert torch.equal(ob.view(torch.int16),
                               got.to(bf16).view(torch.int16)), (structure, B)
            assert torch.equal(ob.view(torch.int16), ob2.view(torch.int16))
            assert torch.equal(fk, fk2), (structure, B)
            gate = tff.chain_gate(fk, tff._chain_forward_plain(
                fx0, fws, fbs, d), L)
            assert gate["ok"], (structure, B, gate)
            w0 = fws[0].clone()
            w0[n_a * dp + n_v * 8] = 0  # m8 = 8 at 4 modes
            ctrl = tff.chain_gate(fk, tff._chain_forward_plain(
                fx0, [w0, *fws[1:]], fbs, d), L)
            assert not ctrl["ok"], (structure, B, ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("d,nb", [(128, 16), (16, 4)],
                         ids=["flagship", "narrow"])
def test_cuda_k2_fold_bias_matches_plain_version(d, nb):
    """K2 on ``fold_bias``'s operands and block list (nonzero biases; the
    folded bias row's gradient is layer 0's bias gradient): under
    ``chain_gate`` against its plain version, both negative controls
    failing it, a repeat launch bit-equal, each launch counted."""
    dev = _cuda()
    cfg, model = _model(d, nb, dev)
    for structure in STRUCTURE_NAMES:
        fblocks = tff.chain_blocks(cfg, structure, fold_bias=True)
        L = len(fblocks.ks)
        for B in (1, 20, 1000):
            args = _shared_inputs(structure, B, dev, seed=B)
            g = torch.randn((B, d), device=dev,
                            generator=torch.Generator(dev).manual_seed(B))
            fx0, fws, fbs, n_a, dp, _ = _chain(model, cfg, structure, args,
                                               fold_bias=True)
            b0 = tff.fused_tgt_backward.launches
            kb = tff._chain_backward(fx0, fws, fbs, g, n_a, d, dp, fblocks)
            kb2 = tff._chain_backward(fx0, fws, fbs, g, n_a, d, dp, fblocks)
            torch.cuda.synchronize()
            assert tff.fused_tgt_backward.launches == b0 + 2
            for a, b in zip([kb[0], *kb[1], *kb[2]],
                            [kb2[0], *kb2[1], *kb2[2]]):
                assert torch.equal(a, b), (structure, B)
            pb = tff._chain_backward_plain(fx0, fws, fbs, g, n_a, d, dp)
            gate = tff.chain_gate(kb, pb, L, fblocks)
            assert gate["ok"], (structure, B, gate)
            for name, x, w in tff.chain_gate_controls(fx0, fws, fblocks, n_a,
                                                      d):
                cb = tff.chain_gate(kb, tff._chain_backward_plain(
                    x, w, fbs, g, n_a, d, dp), L, fblocks)
                assert not cb["ok"], (structure, B, name, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("backward", ["xla", "pallas"])
def test_cuda_encode_dense_fused_out_bf16(backward):
    """``encode_dense_fused(out_bf16=True)`` on the card: the base route's
    output rounded to bf16 (returned as f32), and the same gradients (the
    cotangent is taken in f32 either way)."""
    dev = _cuda()
    cfg, model = _model(128, 16, dev)
    structure = "3-chain_inter"
    args = _shared_inputs(structure, 1000, dev, seed=4)
    g = torch.randn((1000, 128), device=dev,
                    generator=torch.Generator(dev).manual_seed(4))
    outs, grads = [], []
    for out_bf16 in (False, True):
        q = tm.encode_dense_fused(model, cfg, structure, *args, None,
                                  backward, out_bf16=out_bf16)
        outs.append(q)
        grads.append(torch.autograd.grad(q, list(model.parameters()), g,
                                         allow_unused=True))
    assert outs[1].dtype == torch.float32
    assert torch.equal(outs[1], outs[0].to(torch.bfloat16).float())
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), backward


@pytest.mark.cuda
@pytest.mark.parametrize("structure,d", [("3-chain", 128), ("2-inter", 160)])
def test_cuda_k1_k2_every_row_tile(structure, d, monkeypatch):
    """Every row tile the kernels take whose shared memory fits (128 rows
    down to the 8-row tile of the widest chains, forced here), at d_pad =
    128 and 256: K1 gives the same bits at each (each output's sum runs
    over the same k-steps in the same order), K2 passes ``chain_gate``
    (db's partial sums follow the row tiles)."""
    dev = _cuda()
    cfg, model = _model(d, 3, dev)
    blocks = tff.chain_blocks(cfg, structure)
    B = 1000
    args = _shared_inputs(structure, B, dev, seed=3)
    g = torch.randn((B, d), device=dev,
                    generator=torch.Generator(dev).manual_seed(3))
    with torch.no_grad():
        v_slots, dp, cols, Ws, bs = tff._assemble(model, cfg, structure,
                                                  *args, None)
        x0 = tff._layer0_operand(cols, args[1], v_slots, cfg, dp)
        ws = [W.to(torch.bfloat16).contiguous() for W in Ws]
        bs = [b.contiguous() for b in bs]
    L, n_a = len(ws), len(cols)
    pb = tff._chain_backward_plain(x0, ws, bs, g, n_a, d, dp)
    lib = tff._tgt_kernel()
    ks, ns = list(blocks.ks), list(blocks.ns)
    have = lib.mpqe_tgt_max_smem(torch.cuda.current_device())
    outs, ran = [], []
    for tq in (128, 64, 32, 16, 8):
        if max(lib.mpqe_tgt_smem_bytes(bwd, tq, L, tff._ints(ks),
                                       tff._ints(ns)) for bwd in (0, 1)) \
                > have:
            continue
        ran.append(tq)
        monkeypatch.setattr(tff, "_row_tile", lambda *a, tq=tq: tq)
        outs.append(tff._chain_forward(x0, ws, bs, d, blocks))
        kb = tff._chain_backward(x0, ws, bs, g, n_a, d, dp, blocks)
        gate = tff.chain_gate(kb, pb, L, blocks)
        assert gate["ok"], (structure, tq, gate)
    assert ran[-3:] == [32, 16, 8], ran
    for o in outs[1:]:
        assert torch.equal(o, outs[0]), (structure, ran)
    assert tff.chain_gate(outs[0], tff._chain_forward_plain(x0, ws, bs, d),
                          L)["ok"]


@pytest.mark.cuda
def test_cuda_k1_wrapper_checks_its_operands():
    dev = _cuda()
    x0 = torch.zeros((8, 256), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((256, 128), dtype=torch.bfloat16, device=dev)
    b = torch.zeros((128,), dtype=torch.float32, device=dev)
    bad = [
        (x0.float(), [w], [b]),  # wrong dtype
        (x0, [w[:128]], [b]),  # k does not chain
        (x0, [w], [b[:64]]),  # bias shape
        (x0, [w.t().contiguous().t()], [b]),  # not contiguous
        (x0, [w.cpu()], [b]),  # mixed devices
    ]
    blocks = tff.ChainBlocks(128, [256], [128], [[(0, 0), (1, 0)]], 1)
    for x, ws, bs in bad:
        with pytest.raises(ValueError):
            tff._chain_forward(x, ws, bs, 16, blocks)
    with pytest.raises(ValueError):  # a block list of other widths
        tff._chain_forward(x0, [w], [b], 16, tff.ChainBlocks(
            128, [128], [128], [[(0, 0)]], 1))


# ------------------------------------------------------------ K5 and K6
def _sparse_layouts(d, nb, dev, seed=0):
    """(name, K5 chunked dict, K6 bucketed dict, n_nodes): a template
    batch (3-chain_inter, B = 512) and a general random graph (padded
    chunks, off-diagonal buckets)."""
    from mpqe_tpu_torch.ops import edge_store as tes
    from mpqe_tpu_torch.ops import rgcn_blocked as tprb
    from mpqe_tpu_torch.ops import rgcn_fused as tpr
    from mpqe_tpu_torch.ops import template_layout as ttl

    rng = np.random.default_rng(seed)
    s = "3-chain_inter"
    spec = STRUCTURES[s]
    er = torch.from_numpy(rng.integers(0, N_RELS, spec.n_edges).astype(
        np.int32)).to(dev)
    en = torch.from_numpy(rng.uniform(0.5, 1.5, spec.n_edges).astype(
        np.float32)).to(dev)
    B = 512
    out = [("template", ttl.template_chunked(s, er, en, B),
            ttl.template_blocked(s, er, en, B), B * spec.n_nodes)]
    n, E = 4096, 65536
    st = tes.build_edge_store(rng.integers(0, n, E), rng.integers(0, n, E),
                              rng.integers(0, N_RELS, E), n, N_RELS)
    out.append(("general", tpr.chunk_by_relation(st, 512),
                tprb.bucket_edges_blocked(st, 1024, 512), n))
    return out


def _k5_check(fn, ref, xin, sin, w, kargs, c, norm, chunk, bad_c=None,
              w_transposed=False):
    """K5 on one case: one launch counted, <= 1e-4 of its plain version,
    a repeat launch bit-equal, and (``bad_c``: the chunk coefficients or
    relations with one chunk changed) the plain version on ``bad_c``
    failing the gate.  ``kargs``: the kernel's arguments between the
    weights and norm (K5a: coeff, chunk_rel, n_rels; K5b: chunk_rel);
    ``c``: the plain version's (per-chunk coefficients or relations).  The
    plain version with ``w_transposed`` runs on a transposed copy of the
    weights."""
    before = fn.launches
    got = fn(xin, sin, w, *kargs, norm, chunk, w_transposed=w_transposed)
    again = fn(xin, sin, w, *kargs, norm, chunk, w_transposed=w_transposed)
    w_plain = w.transpose(1, 2).contiguous() if w_transposed else w
    want = ref(xin, sin, w_plain, c, norm, chunk)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4, (fn.__name__, _rel(got, want))
    assert torch.equal(got, again), fn.__name__
    if bad_c is not None:
        cut = ref(xin, sin, w_plain, bad_c, norm, chunk)
        assert _rel(got, cut) > 1e-4, (fn.__name__, _rel(got, cut))


def _k5_control(c, norm, chunk, n_rels):
    """``c`` with the first chunk that has a real edge changed: K5a's
    coefficient row negated and shifted, K5b's relation the next one."""
    k = int(torch.nonzero((norm.view(-1, chunk) != 0).any(1))[0, 0])
    bad = c.clone()
    if c.is_floating_point():
        bad[k] = 1.0 - 2.0 * bad[k]
    else:
        bad[k] = (bad[k] + 1) % n_rels
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("d,nb", [(128, 16), (16, 4)],
                         ids=["flagship", "narrow"])
def test_cuda_k5_match_plain_versions(d, nb):
    """K5a and K5b (tensor cores, split TF32) within 1e-4 of their plain
    versions on a template batch and a general graph, gathering and on
    one row per edge, with the weights read as stored and transposed; a
    repeat launch gives the same bits; the negative control (one chunk's
    coefficients or relation changed in the plain version) fails."""
    from mpqe_tpu_torch.ops import rgcn_fused as tpr

    dev = _cuda()
    gen = torch.Generator(dev).manual_seed(d)
    basis = torch.randn((nb, d, d), device=dev, generator=gen) / d ** 0.5
    coeff = torch.randn((N_RELS, nb), device=dev, generator=gen)
    w_rel = torch.einsum("rb,bio->rio", coeff, basis).contiguous()
    for name, ch, _, n in _sparse_layouts(d, nb, dev):
        src = torch.as_tensor(ch["src"]).to(dev).to(torch.int32)
        norm = torch.as_tensor(ch["norm"]).to(dev).float()
        crel = torch.as_tensor(ch["chunk_rel"]).to(dev).to(torch.int32)
        chunk = ch["chunk"]
        x = torch.randn((n, d), device=dev, generator=gen)
        rows = torch.randn((src.shape[0], d), device=dev, generator=gen)
        ce = tpr._masked_chunk_coeff(coeff, crel, N_RELS).contiguous()
        rc = crel.clamp(0, N_RELS - 1)
        for fn, ref, w, kargs, c in (
                (tpr.messages_basis, tpr.messages_basis_reference, basis,
                 (coeff, crel, N_RELS), ce),
                (tpr.messages_wrel, tpr.messages_wrel_reference, w_rel,
                 (crel,), rc)):
            bad = _k5_control(c, norm, chunk, N_RELS)
            for xin, sin in ((x, src), (rows, None)):
                _k5_check(fn, ref, xin, sin, w, kargs, c, norm, chunk, bad)
            _k5_check(fn, ref, rows, None, w, kargs, c, norm, chunk, bad,
                      w_transposed=True)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,n_chunks", [(8, 5), (512, 3), (20, 7),
                                            (100, 2)])
@pytest.mark.parametrize("d_in,d_out", [(128, 128), (16, 24), (36, 20),
                                        (13, 7)])
def test_cuda_k5_ragged_cases(chunk, n_chunks, d_in, d_out):
    """K5 at shapes the train path does not reach: chunks that are not a
    whole number of row tiles (8, 20, 100) and of 512 rows, widths that
    are not multiples of 16 (or of 4: 13, 7), out-of-range src on both
    sides, padding chunks (K5a: chunk_rel = n_rels, zero coefficients),
    runs of equal relations, changes between them and runs of one
    relation that are not adjacent, src = None, and the transposed
    weights; each <= 1e-4 of its plain version, repeats bit-equal."""
    from mpqe_tpu_torch.ops import rgcn_fused as tpr

    dev = _cuda()
    rng = np.random.default_rng(chunk * 131 + d_in)
    R, nb, n = 6, 3, 50

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    E = chunk * n_chunks
    crel = rng.integers(0, R, n_chunks).astype(np.int32)
    crel[1::3] = crel[0::3][:len(crel[1::3])]  # runs of one relation
    if n_chunks >= 5:  # relation a, a, b, a: a run that is not adjacent
        crel[2], crel[3] = (crel[0] + 1) % R, crel[0]
    crel[-1] = R  # a padding chunk
    crel, src = t(crel), t(rng.integers(-3, n + 3, E).astype(np.int32))
    norm = rng.uniform(0.5, 1.5, E).astype(np.float32)
    norm[-chunk:] = 0.0
    norm = t(norm)
    basis = t((rng.normal(size=(nb, d_in, d_out)) / d_in ** 0.5).astype(
        np.float32))
    coeff = t(rng.normal(size=(R, nb)).astype(np.float32))
    w_rel = torch.einsum("rb,bio->rio", coeff, basis).contiguous()
    ce = tpr._masked_chunk_coeff(coeff, crel, R).contiguous()
    rc = crel.clamp(0, R - 1)
    x = t(rng.normal(size=(n, d_in)).astype(np.float32))
    rows = t(rng.normal(size=(E, d_in)).astype(np.float32))
    g = t(rng.normal(size=(E, d_out)).astype(np.float32))
    for fn, ref, w, kargs, c in (
            (tpr.messages_basis, tpr.messages_basis_reference, basis,
             (coeff, crel, R), ce),
            (tpr.messages_wrel, tpr.messages_wrel_reference, w_rel, (crel,),
             rc)):
        bad = _k5_control(c, norm, chunk, R)
        _k5_check(fn, ref, x, src, w, kargs, c, norm, chunk, bad)
        _k5_check(fn, ref, rows, None, w, kargs, c, norm, chunk, bad)
        _k5_check(fn, ref, g, None, w, kargs, c, norm, chunk, bad,
                  w_transposed=True)
    # a padding chunk's messages are 0 (K5a: W = 0; K5b: norm = 0)
    assert not tpr.messages_basis(x, src, basis, coeff, crel, R, norm,
                                  chunk)[-chunk:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d,nb", [(128, 16), (16, 4)],
                         ids=["flagship", "narrow"])
def test_cuda_k6_match_plain_versions(d, nb):
    """K6a (both layouts) within ``blocked_error_bound`` of its plain
    version, K6b under ``k6b_gate``; each negative control fails; a second
    launch on the same inputs gives the same bits."""
    from mpqe_tpu_torch.ops import rgcn_blocked as tprb

    dev = _cuda()
    gen = torch.Generator(dev).manual_seed(d + 1)
    basis = torch.randn((nb, d, d), device=dev, generator=gen) / d ** 0.5
    coeff = torch.randn((N_RELS, nb), device=dev, generator=gen)
    basis_t = basis.transpose(1, 2)
    for name, _, bk, n in _sparse_layouts(d, nb, dev, seed=1):
        lay, t_lay = tprb.layouts_on(bk, dev)
        x = torch.randn((n, d), device=dev, generator=gen)
        g = torch.randn((n, d), device=dev, generator=gen)
        a0, b0 = tprb.messages_blocked.launches, tprb.grad_blocked.launches
        for xin, w, ly in ((x, basis, lay), (g, basis_t, t_lay)):
            got = tprb.messages_blocked(xin, w, coeff, ly, N_RELS)
            again = tprb.messages_blocked(xin, w, coeff, ly, N_RELS)
            msg = tprb._edge_messages(xin, w, coeff, ly, N_RELS)
            want = tprb._dst_sum(msg, ly, n)
            bound = tprb.blocked_error_bound(xin, w, coeff, ly, N_RELS, n,
                                             msg)
            gate = tprb.k6a_gate(got, want, bound)
            assert gate["ok"], (name, gate)
            assert torch.equal(got, again), name
            e = torch.nonzero(tprb._real_edges(ly, n)[2])[:1, 0]
            cut = tprb._dst_sum(msg.index_fill(0, e, 0.0), ly, n)
            assert not tprb.k6a_gate(got, cut, bound)["ok"], name
        got_g = tprb.grad_blocked_parts(x, g, basis, coeff, lay, N_RELS)
        again = tprb.grad_blocked_parts(x, g, basis, coeff, lay, N_RELS)
        want_g = tprb.grad_blocked_reference_parts(x, g, basis, coeff, lay,
                                                   N_RELS)
        s_bound = tprb.grad_s_bound(x, g, basis, lay)
        gate = tprb.k6b_gate(got_g, want_g, s_bound, lay["rel"], N_RELS)
        assert gate["ok"], (name, gate)
        assert all(torch.equal(u, v) for u, v in zip(got_g, again)), name
        r = int(lay["edges"][0, 2])
        cut_lay = dict(lay, norm=torch.where(lay["rel"] == r, 0.0,
                                             lay["norm"]))
        cut = tprb.grad_blocked_reference_parts(x, g, basis, coeff, cut_lay,
                                                N_RELS)
        bad = tprb.k6b_gate(got_g, cut, s_bound, lay["rel"], N_RELS)
        assert not bad["dbasis_ok"] and not bad["dcoeff_ok"], (name, bad)
        torch.cuda.synchronize()
        assert tprb.messages_blocked.launches == a0 + 4
        assert tprb.grad_blocked.launches == b0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(768, 768), (768, 256)])
def test_cuda_k5_wide_rows_go_in_k_stages(K, N):
    """K5a and K5b at K = 768 (rows wider than the small tile's shared
    memory: k in stages), N = K and N != K, 16 bases, on a template batch:
    within 1e-4 of their plain versions, repeats bit-equal, the negative
    control failing; gathering, on one row per edge and transposed."""
    from mpqe_tpu_torch.ops import rgcn_fused as tpr
    from mpqe_tpu_torch.ops import template_layout as ttl

    dev = _cuda()
    rng = np.random.default_rng(K + N)
    s, B, nb = "3-chain_inter", 64, 16
    spec = STRUCTURES[s]
    ch = ttl.template_chunked(
        s, torch.from_numpy(rng.integers(0, N_RELS, spec.n_edges).astype(
            np.int32)).to(dev),
        torch.from_numpy(rng.uniform(0.5, 1.5, spec.n_edges).astype(
            np.float32)).to(dev), B)
    src = ch["src"].to(torch.int32).contiguous()
    norm, crel, chunk = ch["norm"].float().contiguous(), ch[
        "chunk_rel"].to(torch.int32).contiguous(), ch["chunk"]
    gen = torch.Generator(dev).manual_seed(K + N)
    basis = torch.randn((nb, K, N), device=dev, generator=gen) / K ** 0.5
    coeff = torch.randn((N_RELS, nb), device=dev, generator=gen)
    w_rel = torch.einsum("rb,bio->rio", coeff, basis).contiguous()
    x = torch.randn((B * spec.n_nodes, K), device=dev, generator=gen)
    rows = torch.randn((src.shape[0], K), device=dev, generator=gen)
    g = torch.randn((src.shape[0], N), device=dev, generator=gen)
    ce = tpr._masked_chunk_coeff(coeff, crel, N_RELS).contiguous()
    rc = crel.clamp(0, N_RELS - 1)
    for fn, ref, w, kargs, c in (
            (tpr.messages_basis, tpr.messages_basis_reference, basis,
             (coeff, crel, N_RELS), ce),
            (tpr.messages_wrel, tpr.messages_wrel_reference, w_rel, (crel,),
             rc)):
        bad = _k5_control(c, norm, chunk, N_RELS)
        _k5_check(fn, ref, x, src, w, kargs, c, norm, chunk, bad)
        _k5_check(fn, ref, rows, None, w, kargs, c, norm, chunk, bad)
        _k5_check(fn, ref, g, None, w, kargs, c, norm, chunk, bad,
                  w_transposed=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 512])
def test_cuda_k6_wide_widths(d):
    """K6a (both layouts; the basis streamed) under ``blocked_error_bound``
    and K6b (dbasis in tiles, s_eb from column tiles) under ``k6b_gate``
    at d = 256 and 512 with 16 bases, on a template batch; controls fail,
    repeats bit-equal."""
    from mpqe_tpu_torch.ops import rgcn_blocked as tprb
    from mpqe_tpu_torch.ops import template_layout as ttl

    dev = _cuda()
    rng = np.random.default_rng(d)
    s, B, nb = "3-chain_inter", 64, 16
    spec = STRUCTURES[s]
    bk = ttl.template_blocked(
        s, torch.from_numpy(rng.integers(0, N_RELS, spec.n_edges).astype(
            np.int32)).to(dev),
        torch.from_numpy(rng.uniform(0.5, 1.5, spec.n_edges).astype(
            np.float32)).to(dev), B)
    lay, t_lay = tprb.layouts_on(bk, dev)
    n = B * spec.n_nodes
    gen = torch.Generator(dev).manual_seed(d)
    basis = torch.randn((nb, d, d), device=dev, generator=gen) / d ** 0.5
    coeff = torch.randn((N_RELS, nb), device=dev, generator=gen)
    x = torch.randn((n, d), device=dev, generator=gen)
    g = torch.randn((n, d), device=dev, generator=gen)
    for xin, w, ly in ((x, basis, lay), (g, basis.transpose(1, 2), t_lay)):
        got = tprb.messages_blocked(xin, w, coeff, ly, N_RELS)
        again = tprb.messages_blocked(xin, w, coeff, ly, N_RELS)
        msg = tprb._edge_messages(xin, w, coeff, ly, N_RELS)
        bound = tprb.blocked_error_bound(xin, w, coeff, ly, N_RELS, n, msg)
        gate = tprb.k6a_gate(got, tprb._dst_sum(msg, ly, n), bound)
        assert gate["ok"], gate
        assert torch.equal(got, again)
        e = torch.nonzero(tprb._real_edges(ly, n)[2])[:1, 0]
        cut = tprb._dst_sum(msg.index_fill(0, e, 0.0), ly, n)
        assert not tprb.k6a_gate(got, cut, bound)["ok"]
    got_g = tprb.grad_blocked_parts(x, g, basis, coeff, lay, N_RELS)
    again = tprb.grad_blocked_parts(x, g, basis, coeff, lay, N_RELS)
    want_g = tprb.grad_blocked_reference_parts(x, g, basis, coeff, lay,
                                               N_RELS)
    s_bound = tprb.grad_s_bound(x, g, basis, lay)
    gate = tprb.k6b_gate(got_g, want_g, s_bound, lay["rel"], N_RELS)
    assert gate["ok"], gate
    assert all(torch.equal(u, v) for u, v in zip(got_g, again))
    r = int(lay["edges"][0, 2])
    cut_lay = dict(lay, norm=torch.where(lay["rel"] == r, 0.0, lay["norm"]))
    bad = tprb.k6b_gate(got_g, tprb.grad_blocked_reference_parts(
        x, g, basis, coeff, cut_lay, N_RELS), s_bound, lay["rel"], N_RELS)
    assert not bad["dbasis_ok"] and not bad["dcoeff_ok"], bad


@pytest.mark.cuda
def test_cuda_k5_k6_wrappers_check_their_inputs():
    from mpqe_tpu_torch.ops import rgcn_blocked as tprb
    from mpqe_tpu_torch.ops import rgcn_fused as tpr

    dev = _cuda()
    d, nb, chunk = 16, 2, 8
    x = torch.zeros((32, d), device=dev)
    src = torch.zeros((16,), dtype=torch.int32, device=dev)
    basis = torch.zeros((nb, d, d), device=dev)
    coeff = torch.zeros((3, nb), device=dev)
    crel = torch.zeros(2, dtype=torch.int32, device=dev)
    norm = torch.zeros((16,), device=dev)
    bad = [
        (x.double(), src, basis, coeff, crel, norm),  # wrong dtype
        (x, src.long(), basis, coeff, crel, norm),
        (x, src, basis, coeff.double(), crel, norm),
        (x, src, basis, coeff[:2], crel, norm),  # wrong shape
        (x, src, basis, coeff, crel[:1], norm),
        (x, src, basis.transpose(1, 2), coeff, crel, norm),  # not contiguous
        (x, src.cpu(), basis, coeff, crel, norm),  # mixed devices
        (x, src, basis, coeff, crel.cpu(), norm),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tpr.messages_basis(*args[:5], 3, args[5], chunk)
    with pytest.raises(ValueError):  # 16 edges are not chunks of 5
        tpr.messages_basis(x, src, basis, coeff, crel, 3, norm, 5)
    with pytest.raises(ValueError):  # transposed: [nb, N, K], K = 8 != 16
        tpr.messages_basis(x, src, basis[:, :, :8].contiguous(), coeff, crel,
                           3, norm, chunk, w_transposed=True)
    # the limit K5 keeps: int32 edge ids (2^31 edges: 8 GiB of norms)
    huge = torch.empty((2 ** 31,), device=dev)
    with pytest.raises(ValueError, match="int32"):
        tpr.messages_wrel(x, src, basis, crel, huge, chunk)
    del huge
    lay = tprb.layout_on({
        "src_local": np.zeros(16, np.int32), "dst_local": np.zeros(16, np.int32),
        "rel": np.zeros(16, np.int32), "norm": np.zeros(16, np.float32),
        "chunk_src_blk": np.zeros(2, np.int32),
        "chunk_dst_blk": np.zeros(2, np.int32), "node_block": 32,
        "chunk": chunk}, dev)
    coeff = torch.zeros((3, nb), device=dev)
    for args in ((x[:, :8], basis, coeff), (x, basis, coeff[:2]),
                 (x, basis.cpu(), coeff)):
        with pytest.raises(ValueError):
            tprb.messages_blocked(*args, lay, 3)
    broken = dict(lay, rel=lay["rel"][:8])
    with pytest.raises(ValueError):
        tprb.messages_blocked(x, basis, coeff, broken, 3)
    with pytest.raises(ValueError):
        tprb.grad_blocked(x, x[:, :8], basis, coeff, lay, 3)
    # the limits K6 keeps: its grids' 65,535 bases (K6b, blockIdx.y) and
    # column tiles (K6a, blockIdx.y)
    many = torch.zeros((65536, d, d), device=dev)
    with pytest.raises(ValueError, match="65,535"):
        tprb.grad_blocked(x, x, many, torch.zeros((3, 65536), device=dev),
                          lay, 3)
    del many
    wide = torch.zeros((1, d, 32 * 65535 + 1), device=dev)
    with pytest.raises(ValueError, match="column tiles"):
        tprb.messages_blocked(x, wide, torch.zeros((3, 1), device=dev), lay,
                              3)


# ------------------------------------------------------------ K4 and K7
def _segment_cases(d, dev, seed=0):
    """(name, data, ids, num_segments): the reference's chip-check shape,
    a batch's destination sum (ids in ascending blocks, as dense_to_sparse
    leaves them within a relation), out-of-range ids with empty segments,
    and the cap."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(dev)

    out = []
    for name, E, S in (("tpu_smoke", 1000, 64), ("batch", 3072, 4096),
                       ("cap", 40000, 8192)):
        ids = rng.integers(0, S, E).astype(np.int32)
        if name == "batch":
            ids = np.sort(ids)
        out.append((name, t(rng.normal(size=(E, d)).astype(np.float32)),
                    t(ids), S))
    ids = np.array([0, 1, 2, 3, 4, 99, 99, -1, 2, 0] * 7, np.int32)
    out.append(("out_of_range", t(rng.normal(size=(70, d)).astype(
        np.float32)), t(ids), 9))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128])
def test_cuda_k4_match_plain_versions(d):
    from mpqe_tpu_torch.ops import segment_kernels as sk

    dev = _cuda()
    for name, data, ids, S in _segment_cases(d, dev, seed=d):
        a0, b0 = sk.segment_sum_kernel.launches, sk.segment_max_kernel.launches
        got_s = sk.segment_sum_kernel(data, ids, S)
        got_m = sk.segment_max_kernel(data, ids, S)
        want_s = sk.segment_sum_reference(data, ids, S)
        want_m = sk.segment_max_reference(data, ids, S)
        torch.cuda.synchronize()
        assert sk.segment_sum_kernel.launches == a0 + 1
        assert sk.segment_max_kernel.launches == b0 + 1
        assert _rel(got_s, want_s) <= 1e-4, (name, _rel(got_s, want_s))
        assert torch.equal(got_m, want_m), name
        oracle = torch.zeros((S, d), dtype=torch.float64, device=dev)
        ok = (ids >= 0) & (ids < S)
        oracle.index_add_(0, ids[ok].long(), data[ok].double())
        assert _rel(got_s.double(), oracle) <= 1e-5, name
        empty = torch.bincount(ids[ok].long(), minlength=S) == 0
        assert bool((got_m[empty] == sk.NEG_INF).all())
        assert bool((got_s[empty] == 0).all())


def _layout_cases(dev):
    """(name, ids, num_segments) for the layout kernel: no rows, the
    chip-check shape, each structure's destination and readout ids at
    B = 1,024 (with padding edges), the one-block limit and one row past
    it, and 2^20 rows at the cap; ids out of range both ways and empty
    segments throughout, int32 and int64."""
    from mpqe_tpu_torch.data.batcher import (DenseQueryBatch,
                                             dense_to_sparse,
                                             template_edge_norm)

    rng = np.random.default_rng(17)

    def knocked(E, S, dtype=np.int32):
        ids = rng.integers(0, S, E).astype(dtype)
        ids[ids == min(7, S - 1)] = S + 3  # an empty segment
        bad = rng.choice(E, max(E // 50, 2), replace=False)
        ids[bad[::2]] = -1 - rng.integers(0, 5, len(bad[::2]))
        ids[bad[1::2]] = S
        return torch.from_numpy(ids).to(dev)

    out = [("no_rows", torch.zeros(0, dtype=torch.int32, device=dev), 16),
           ("tpu_smoke", knocked(1000, 64), 64),
           ("tpu_smoke_i64", knocked(1000, 64, np.int64), 64)]
    B = 1024
    for s in STRUCTURE_NAMES:
        spec = STRUCTURES[s]
        rels = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
        b = DenseQueryBatch(
            s, B, rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rels, template_edge_norm(spec, rels), np.zeros(B, np.int32),
            np.zeros((B, 1), np.int32), np.ones((B, 1), np.float32),
            np.ones(B, np.float32))
        sb = dense_to_sparse(b, N_RELS, B * spec.n_edges + 64)
        out.append((f"{s}.dst", torch.from_numpy(sb.edges.dst).to(dev),
                    sb.n_nodes))
        out.append((f"{s}.query", torch.from_numpy(sb.node_query).to(dev),
                    B))
    out += [("one_block", knocked(8192, 4096), 4096),
            ("two_ranges", knocked(8193, 8192), 8192),
            ("ranges", knocked(40000, 300, np.int64), 300),
            ("cap", knocked(1 << 20, 8192), 8192)]
    return out


@pytest.mark.cuda
def test_cuda_k4_layout_matches_plain_layout():
    from mpqe_tpu_torch.ops import segment_kernels as sk

    dev = _cuda()
    for name, ids, S in _layout_cases(dev):
        l0 = sk.segment_layout.launches
        perm, offs = sk.segment_layout(ids, S)
        again = sk.segment_layout(ids, S)
        want_perm, want_offs = sk.segment_layout_reference(ids, S)
        torch.cuda.synchronize()
        assert sk.segment_layout.launches == l0 + 2, name
        assert perm.dtype == offs.dtype == torch.int32, name
        assert torch.equal(perm, want_perm), name
        assert torch.equal(offs, want_offs), name
        assert torch.equal(again[0], perm) and torch.equal(again[1], offs)


@pytest.mark.cuda
def test_cuda_k4_with_a_given_layout_equals_without():
    from mpqe_tpu_torch.ops import segment_kernels as sk

    dev = _cuda()
    gen = torch.Generator(dev).manual_seed(9)
    for name, ids, S in _layout_cases(dev):
        if ids.shape[0] > 100_000:
            continue  # the cap's rows: chip_smoke.py's kernel.segment
        data = torch.randn((ids.shape[0], 128), device=dev, generator=gen)
        layout = sk.segment_layout(ids, S)
        counts = (sk.segment_layout.launches, sk.segment_sum_kernel.launches,
                  sk.segment_max_kernel.launches)
        got_s = sk.segment_sum_kernel(data, ids, S, layout=layout)
        got_m = sk.segment_max_kernel(data, ids, S, layout=layout)
        assert (sk.segment_layout.launches, sk.segment_sum_kernel.launches,
                sk.segment_max_kernel.launches) == (
            counts[0], counts[1] + 1, counts[2] + 1), name
        want_s = sk.segment_sum_kernel(data, ids, S)
        want_m = sk.segment_max_kernel(data, ids, S)
        assert sk.segment_layout.launches == counts[0] + 2, name
        plain_s = sk.segment_sum_reference(data, ids, S, layout=layout)
        torch.cuda.synchronize()
        assert torch.equal(got_s, want_s) and torch.equal(got_m, want_m), name
        assert torch.equal(got_s, plain_s), name
        if name == "ranges":  # a layout of other ids is refused
            with pytest.raises(ValueError, match="layout perm"):
                sk.segment_sum_kernel(data, ids, S, layout=(layout[0][:-1],
                                                            layout[1]))


@pytest.mark.cuda
def test_cuda_k4_nan_inf_bf16_and_cap():
    from mpqe_tpu_torch.ops import segment_kernels as sk

    dev = _cuda()
    data = torch.randn((12, 8), device=dev)
    data[3, 2] = float("nan")
    data[5, 1] = float("-inf")
    data[6, :] = float("-inf")  # a segment of -inf rows stays at -1e30
    ids = torch.tensor([0, 0, 1, 1, 2, 2, 3, 1, 0, 2, 5, 5], device=dev)
    got = sk.segment_max_kernel(data, ids, 6)
    want = sk.segment_max_reference(data, ids, 6)
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(got[1, 2].isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert bool((got[3] == sk.NEG_INF).all()) and bool(
        (got[4] == sk.NEG_INF).all())
    got_s = sk.segment_sum_kernel(data, ids, 6)
    want_s = sk.segment_sum_reference(data, ids, 6)
    assert torch.equal(got_s.isnan(), want_s.isnan())
    assert torch.equal(torch.nan_to_num(got_s), torch.nan_to_num(want_s))
    half = data.nan_to_num().clamp(-10, 10).to(torch.bfloat16)
    for k, r in ((sk.segment_sum_kernel, sk.segment_sum_reference),
                 (sk.segment_max_kernel, sk.segment_max_reference)):
        g = k(half, ids, 6)
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, r(half, ids, 6))
        k(data[:0], ids[:0], 8192)  # the cap itself
        with pytest.raises(ValueError):
            k(data, ids, 8193)
    with pytest.raises(NotImplementedError, match="forward only"):
        sk.segment_sum_kernel(data.clone().requires_grad_(), ids, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 16, 37, 128])
def test_cuda_k7_matches_plain_version(d):
    """K7 bit-equal to its plain version (the same sum order), on ragged
    edge counts and widths that are not multiples of 4 or 32."""
    from mpqe_tpu_torch.ops import sddmm as tsd

    dev = _cuda()
    gen = torch.Generator(dev).manual_seed(d)
    for n, E in ((512, 2047), (4096, 3071), (8191, 65537)):
        x = torch.randn((n, d), device=dev, generator=gen)
        y = torch.randn((n, d), device=dev, generator=gen)
        src = torch.randint(0, n, (E,), device=dev, generator=gen,
                            dtype=torch.int32)
        dst = torch.randint(0, n, (E,), device=dev, generator=gen,
                            dtype=torch.int32)
        src[:5] = torch.tensor([-1, n, 0, 3 * n, 1], device=dev)
        dst[5:7] = torch.tensor([n + 7, -4], device=dev)
        before = tsd.sddmm_kernel.launches
        got = tsd.sddmm_kernel(x, y, src, dst)
        want = tsd.sddmm_reference(x, y, src, dst)
        torch.cuda.synchronize()
        assert tsd.sddmm_kernel.launches == before + 1
        assert torch.equal(got, want), (n, d, _rel(got, want))
        assert bool((got[[0, 1, 3, 5, 6]] == 0).all())
        oracle = tsd.sddmm_xla(x.double(), y.double(), src, dst)
        assert _rel(got.double(), oracle) <= 1e-5
        # rows that are not 16-byte aligned take the 4-byte loads
        xo = x.flatten()[1:(n - 1) * d + 1].view(n - 1, d)
        yo = y.flatten()[1:(n - 1) * d + 1].view(n - 1, d)
        assert torch.equal(tsd.sddmm_kernel(xo, yo, src, dst),
                           tsd.sddmm_reference(xo, yo, src, dst))
    with pytest.raises(ValueError):
        tsd.sddmm_kernel(torch.zeros((8192, d), device=dev),
                         torch.zeros((8192, d), device=dev), src[:4], dst[:4])
    with pytest.raises(NotImplementedError, match="forward only"):
        tsd.sddmm_kernel(x.requires_grad_(), y, src, dst)


@pytest.mark.cuda
@pytest.mark.parametrize("readout", ["tgt", "max", "mlp"])
def test_cuda_encode_sparse_pallas_matches_cpu_plain_path(readout):
    from mpqe_tpu_torch.data.batcher import (DenseQueryBatch,
                                             dense_to_sparse,
                                             template_edge_norm)
    from mpqe_tpu_torch.ops import segment_kernels as sk

    dev = _cuda()
    cfg = tm.MPQEConfig(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
                        embed_dim=128, n_layers=3, num_bases=16,
                        readout=readout)
    gen = torch.Generator(dev).manual_seed(3)
    model = tm.init_mpqe(gen, cfg, device=dev)
    cpu_model = tm.MPQE(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    rng = np.random.default_rng(4)
    for s in STRUCTURE_NAMES:
        spec = STRUCTURES[s]
        B = 1024
        rels = rng.integers(0, N_RELS, spec.n_edges).astype(np.int32)
        b = DenseQueryBatch(
            s, B, rng.integers(0, N_ENT, (B, spec.n_nodes)).astype(np.int32),
            rng.integers(0, N_MODES, (B, spec.n_nodes)).astype(np.int32),
            rels, template_edge_norm(spec, rels), np.zeros(B, np.int32),
            np.zeros((B, 1), np.int32), np.ones((B, 1), np.float32),
            np.ones(B, np.float32))
        sb = dense_to_sparse(b, N_RELS)
        arrays = (sb.node_entity, sb.node_mode, sb.node_is_var,
                  sb.edges.src, sb.edges.dst, sb.edges.rel, sb.edges.norm,
                  sb.node_query, sb.target_node)
        a0, b0 = sk.segment_sum_kernel.launches, sk.segment_max_kernel.launches
        l0 = sk.segment_layout.launches
        with torch.no_grad():
            got = tm.encode_sparse(
                model, cfg, s, *(torch.from_numpy(a).to(dev) for a in arrays),
                B, segment_backend="pallas")
            want = tm.encode_sparse(
                cpu_model, cfg, s, *(torch.from_numpy(a) for a in arrays), B,
                segment_backend="pallas")
        steps = tm.num_steps(cfg, s)
        assert sk.segment_sum_kernel.launches - a0 == steps + (
            readout == "mlp")
        assert sk.segment_max_kernel.launches - b0 == (readout == "max")
        # one layout for every layer's destination sum, one for the readout
        assert sk.segment_layout.launches - l0 == 1 + (readout != "tgt")
        assert got.shape == (B, 128)
        assert _rel(got.cpu(), want) <= 1e-5, (s, readout)


@pytest.mark.cuda
@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("d,nb", [(128, 16), (16, 3)], ids=["flagship",
                                                             "narrow"])
def test_cuda_k8_matches_plain_version(n_parts, d, nb):
    # a ring of n_parts parts on one card: 6 + 2 P launches (five layout
    # kernels, the combine; per hop the messages and the destination sum),
    # held to ring_gate
    # against the plain version and rgcn_ring_halo; both controls fail it;
    # a repeat gives the same bits
    from mpqe_tpu_torch.ops import rgcn as trg
    from mpqe_tpu_torch.ops import ring as tring
    from mpqe_tpu_torch.ops.edge_store import build_edge_store
    from mpqe_tpu_torch.parallel import halo as thalo
    from mpqe_tpu_torch.parallel import mesh as tmesh

    dev = _cuda()
    rng = np.random.default_rng(n_parts)
    n, e = 1000, 8000
    st = build_edge_store(rng.integers(0, n, e), rng.integers(0, n, e),
                          rng.integers(0, N_RELS, e), n, N_RELS)
    pr = thalo.partition_edges_ring(st, n_parts)
    gen = torch.Generator(device=dev).manual_seed(n_parts)
    layer = trg.init_rgcn_layer(gen, d, d, N_RELS, nb, device=dev)
    x = torch.randn((pr.n_nodes_padded, d), generator=gen, device=dev)
    edges = [torch.from_numpy(a).to(dev)
             for a in (pr.src_local, pr.dst_local, pr.rel, pr.norm)]
    mesh = tmesh.make_mesh((n_parts, 1), devices=[dev] * n_parts)
    before = tring.rgcn_ring_halo_rdma.launches
    with torch.no_grad():
        got = tring.rgcn_ring_halo_rdma(mesh, layer, x, *edges, N_RELS)
        n_launch = tring.rgcn_ring_halo_rdma.launches - before
        again = tring.rgcn_ring_halo_rdma(mesh, layer, x, *edges, N_RELS)
        want = tring.rgcn_ring_halo_rdma_reference(mesh, layer, x, *edges,
                                                   N_RELS)
        ring = thalo.rgcn_ring_halo(mesh, layer, x, *edges, N_RELS)
        ctl = [tring.rgcn_ring_halo_rdma_reference(mesh, layer, x, *c,
                                                   N_RELS)
               for c in tring.ring_controls(edges, N_RELS, pr.block_size)]
    torch.cuda.synchronize()
    assert n_launch == 6 + 2 * n_parts
    assert got.shape == (pr.n_nodes_padded, d) and got.device.type == "cuda"
    gate = tring.ring_gate(got, want, [(got, ring)])
    assert gate["ok"], gate
    assert torch.equal(got, again)
    assert not any(tring.ring_gate(got, c)["ok"] for c in ctl)


# ------------------------------------------- K5, K6, K8 on bf16 operands
@pytest.mark.cuda
@pytest.mark.parametrize("K,N,layout", [
    (128, 128, "template"), (128, 128, "general"), (200, 200, "template"),
    (768, 256, "template"), (36, 20, "ragged"), (13, 7, "ragged")])
def test_cuda_k5_bf16_rows_equal_f32_rows(K, N, layout):
    """K5a and K5b on bf16 rows (gathered as stored, widened in the
    kernel, one of the three split-TF32 passes skipped) bit-equal to the
    f32-row kernel on ``x.float()``, gathering and on one row per edge;
    within 1e-4 of the plain version; repeats bit-equal.  K = 36 and 13
    are not multiples of 8: the rows go by 2-byte copies; 768: in k
    stages."""
    from mpqe_tpu_torch.ops import edge_store as tes
    from mpqe_tpu_torch.ops import rgcn_fused as tpr
    from mpqe_tpu_torch.ops import template_layout as ttl

    dev = _cuda()
    rng = np.random.default_rng(K + N)
    R, nb = 6, 4
    if layout == "template":
        s, B = "3-chain_inter", 128
        spec = STRUCTURES[s]
        ch = ttl.template_chunked(
            s, torch.from_numpy(rng.integers(0, R, spec.n_edges).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.uniform(0.5, 1.5, spec.n_edges).astype(
                np.float32)).to(dev), B)
        n = B * spec.n_nodes
    else:
        n, E = (2000, 20000) if layout == "general" else (50, 300)
        st = tes.build_edge_store(rng.integers(0, n, E),
                                  rng.integers(0, n, E),
                                  rng.integers(0, R, E), n, R)
        ch = tpr.chunk_by_relation(st, 512 if layout == "general" else 20)
    src = torch.as_tensor(ch["src"]).to(dev).to(torch.int32)
    norm = torch.as_tensor(ch["norm"]).to(dev).float()
    crel = torch.as_tensor(ch["chunk_rel"]).to(dev).to(torch.int32)
    chunk = ch["chunk"]
    gen = torch.Generator(dev).manual_seed(K)
    basis = torch.randn((nb, K, N), device=dev, generator=gen) / K ** 0.5
    coeff = torch.randn((R, nb), device=dev, generator=gen)
    w_rel = torch.einsum("rb,bio->rio", coeff, basis).contiguous()
    x = torch.randn((n, K), device=dev, generator=gen).to(torch.bfloat16)
    rows = torch.randn((src.shape[0], K), device=dev, generator=gen).to(
        torch.bfloat16)
    ce = tpr._masked_chunk_coeff(coeff, crel, R).contiguous()
    rc = crel.clamp(0, R - 1)
    for fn, ref, w, kargs, c in (
            (tpr.messages_basis, tpr.messages_basis_reference, basis,
             (coeff, crel, R), ce),
            (tpr.messages_wrel, tpr.messages_wrel_reference, w_rel, (crel,),
             rc)):
        for xin, sin in ((x, src), (rows, None)):
            before = fn.launches
            got = fn(xin, sin, w, *kargs, norm, chunk)
            again = fn(xin, sin, w, *kargs, norm, chunk)
            f32_rows = fn(xin.float(), sin, w, *kargs, norm, chunk)
            want = ref(xin, sin, w, c, norm, chunk)
            torch.cuda.synchronize()
            assert fn.launches == before + 3
            assert torch.equal(got.view(torch.int32),
                               f32_rows.view(torch.int32)), fn.__name__
            assert torch.equal(got, again), fn.__name__
            assert _rel(got, want) <= 1e-4, (fn.__name__, _rel(got, want))


@pytest.mark.cuda
def test_cuda_k6_bf16_leaves():
    """The blocked layer with bf16 leaves and bf16 rows against the same
    values in f32 leaves (the kernels read bf16 either way): the forward
    bit-equal, every gradient bf16, each leaf's equal to the f32 leaves'
    gradient rounded and the rows' to the bf16 sum of its two parts
    rounded (the self term's and K6a's, as bf16 cotangents add); repeats
    bit-equal."""
    from mpqe_tpu_torch.ops import rgcn as trg
    from mpqe_tpu_torch.ops import rgcn_blocked as tprb

    dev = _cuda()
    gen = torch.Generator(dev).manual_seed(16)
    layer16 = trg.init_rgcn_layer(gen, 128, 128, N_RELS, 16, device=dev)
    layer16.to(torch.bfloat16)
    layer32 = trg.init_rgcn_layer(gen, 128, 128, N_RELS, 16, device=dev)
    with torch.no_grad():
        for p16, p32 in zip(layer16.parameters(), layer32.parameters()):
            p32.copy_(p16.float())
    for name, _, bk, n in _sparse_layouts(128, 16, dev, seed=2):
        lays = tprb.layouts_on(bk, dev)
        x16 = torch.randn((n, 128), device=dev, generator=gen).to(
            torch.bfloat16)
        g = torch.randn((n, 128), device=dev, generator=gen)
        outs = []
        for layer, x in ((layer16, x16), (layer16, x16),
                         (layer32, x16.float())):
            xr = x.clone().requires_grad_()
            out = tprb.rgcn_sparse_blocked(xr, layer, lays, N_RELS)
            grads = torch.autograd.grad(out, [xr, *layer.parameters()], g)
            outs.append((out.detach(), grads))
        torch.cuda.synchronize()
        (o16, g16), (o16b, g16b), (o32, g32) = outs
        assert o16.dtype == torch.float32
        assert torch.equal(o16, o16b) and torch.equal(o16, o32), name
        for a, b, c in zip(g16, g16b, g32):
            assert a.dtype == torch.bfloat16, name
            assert torch.equal(a, b), name
        for a, c in zip(g16[1:], g32[1:]):
            assert torch.equal(a, c.to(torch.bfloat16)), name
        # the rows' gradient: its two parts (K6a's dx, the self term's),
        # each rounded to bf16, then added in bf16
        with torch.no_grad():
            parts = (tprb.messages_blocked(g, layer32.basis.transpose(1, 2),
                                           layer32.coeff, lays[1], N_RELS),
                     g @ layer32.w_self.t())
        want = sum(t.to(torch.bfloat16).float() for t in parts)
        assert torch.equal(g16[0], want.to(torch.bfloat16)), name


@pytest.mark.cuda
def test_cuda_k8_bf16_operands():
    """K8 at P = 4 on a bf16 layer and bf16 rows: bit-equal to K8 on the
    widened operands, under ``ring_gate`` against the plain version."""
    from mpqe_tpu_torch.ops import rgcn as trg
    from mpqe_tpu_torch.ops import ring as tring
    from mpqe_tpu_torch.ops.edge_store import build_edge_store
    from mpqe_tpu_torch.parallel import halo as thalo
    from mpqe_tpu_torch.parallel import mesh as tmesh

    dev = _cuda()
    rng = np.random.default_rng(4)
    n, e, P = 1000, 8000, 4
    st = build_edge_store(rng.integers(0, n, e), rng.integers(0, n, e),
                          rng.integers(0, N_RELS, e), n, N_RELS)
    pr = thalo.partition_edges_ring(st, P)
    gen = torch.Generator(device=dev).manual_seed(4)
    layer = trg.init_rgcn_layer(gen, 128, 128, N_RELS, 16, device=dev)
    layer.to(torch.bfloat16)
    wide = trg.init_rgcn_layer(gen, 128, 128, N_RELS, 16, device=dev)
    with torch.no_grad():
        for a, b in zip(wide.parameters(), layer.parameters()):
            a.copy_(b.float())
    x = torch.randn((pr.n_nodes_padded, 128), generator=gen,
                    device=dev).to(torch.bfloat16)
    edges = [torch.from_numpy(a).to(dev)
             for a in (pr.src_local, pr.dst_local, pr.rel, pr.norm)]
    mesh = tmesh.make_mesh((P, 1), devices=[dev] * P)
    with torch.no_grad():
        got = tring.rgcn_ring_halo_rdma(mesh, layer, x, *edges, N_RELS)
        again = tring.rgcn_ring_halo_rdma(mesh, layer, x, *edges, N_RELS)
        widened = tring.rgcn_ring_halo_rdma(mesh, wide, x.float(), *edges,
                                            N_RELS)
        want = tring.rgcn_ring_halo_rdma_reference(mesh, layer, x, *edges,
                                                   N_RELS)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, widened) and torch.equal(got, again)
    assert tring.ring_gate(got, want)["ok"]


@pytest.mark.cuda
def test_cuda_k8_odd_ids_follow_the_plain_version():
    # ids the partitioners never make: src outside the block (a zero row),
    # rel outside [0, n_rels) (a zero W), dst outside (dropped), on the
    # card under ring_gate against the plain version
    from mpqe_tpu_torch.ops import rgcn as trg
    from mpqe_tpu_torch.ops import ring as tring
    from mpqe_tpu_torch.ops.edge_store import build_edge_store
    from mpqe_tpu_torch.parallel import halo as thalo
    from mpqe_tpu_torch.parallel import mesh as tmesh

    dev = _cuda()
    rng = np.random.default_rng(3)
    n, e, P, d = 600, 5000, 3, 128
    st = build_edge_store(rng.integers(0, n, e), rng.integers(0, n, e),
                          rng.integers(0, N_RELS, e), n, N_RELS)
    pr = thalo.partition_edges_ring(st, P)
    src, dst, rel = (a.copy() for a in (pr.src_local, pr.dst_local, pr.rel))
    real = dst < pr.block_size
    pick = lambda: rng.random(src.shape) < 0.1  # noqa: E731
    src[real & pick()] = pr.block_size + 3
    src[real & pick()] = -2
    rel[real & pick()] = -1
    rel[real & pick()] = N_RELS + 1
    dst[real & pick()] = -5
    gen = torch.Generator(device=dev).manual_seed(3)
    layer = trg.init_rgcn_layer(gen, d, d, N_RELS, 16, device=dev)
    x = torch.randn((pr.n_nodes_padded, d), generator=gen, device=dev)
    edges = [torch.from_numpy(a).to(dev) for a in (src, dst, rel, pr.norm)]
    mesh = tmesh.make_mesh((P, 1), devices=[dev] * P)
    with torch.no_grad():
        got = tring.rgcn_ring_halo_rdma(mesh, layer, x, *edges, N_RELS)
        want = tring.rgcn_ring_halo_rdma_reference(mesh, layer, x, *edges,
                                                   N_RELS)
    gate = tring.ring_gate(got, want)
    assert gate["ok"], gate
    # the layout kernels' route equals ring_route's where the kernels read
    devs = mesh.axis_devices("data")
    with torch.no_grad():
        lay_k, lay_p = (tring._groups(devs, layer, x, edges, pr.block_size,
                                      N_RELS, kind)[devs[0]].route
                        for kind in ("kernel", "plain"))
    assert tring.route_matches(lay_k, lay_p)


def _gqe_kg():
    from mpqe_tpu_torch.data.sampler import make_random_kg

    return make_random_kg(n_entities=N_ENT, n_modes=N_MODES, n_base_rels=133,
                          n_triples=20000, seed=0)


def _gqe_model(decoder, dev, soft_and=False, seed=0):
    from mpqe_tpu_torch.models import gqe as tgqe

    cfg = tgqe.GQEConfig(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
                         embed_dim=128, decoder=decoder, soft_and=soft_and)
    return cfg, tgqe.init_gqe(torch.Generator(device=dev).manual_seed(seed),
                              cfg, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("decoder", ["bilinear", "box"])
def test_cuda_gqe_train_step_matches_cpu(decoder):
    """One GQE train step per structure on the card and on a CPU copy of
    the model (float32 both, TF32 off): the same loss (<= 1e-5 relative)
    and gradients (per leaf mean|diff| / mean|ref| <= 1e-4, the
    ``gqe.train`` recheck of chip_smoke.py; the box attention's second
    bias, whose gradient is zero in exact arithmetic, excepted)."""
    import copy

    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.data.store import build_stores, pack_dense_batch_np
    from mpqe_tpu_torch.models import gqe as tgqe
    from mpqe_tpu_torch.queries import group_queries_by_formula
    from mpqe_tpu_torch.train import loop as tloop

    dev = _cuda()
    kg = _gqe_kg()
    cfg, model = _gqe_model(decoder, dev, seed=1)
    cpu = copy.deepcopy(model).to("cpu")
    sampler = QuerySampler(kg, seed=2)
    stores = build_stores(group_queries_by_formula(
        [q for s in STRUCTURE_NAMES
         for q in sampler.sample_queries(s, 40, n_neg=8)]), kg=kg)
    for s, fstores in stores.items():
        fs = max(fstores, key=lambda f: f.n_queries)
        batch = pack_dense_batch_np(fs, np.arange(fs.n_queries), 512, 4, 3)
        out = []
        for m, d in ((model, dev), (cpu, torch.device("cpu"))):
            loss = tgqe.dense_batch_loss(m, cfg, s,
                                         *tloop.batch_tensors(batch, d))
            names = [n for n, _ in m.named_parameters()]
            gs = torch.autograd.grad(loss, list(m.parameters()),
                                     allow_unused=True)
            out.append((float(loss.detach()),
                        {n: g.cpu() for n, g in zip(names, gs)
                                      if g is not None}))
        (lk, gk), (lp, gp) = out
        assert abs(lk - lp) <= 1e-5 * abs(lp), (s, lk, lp)
        assert set(gk) == set(gp)
        for n, w in gp.items():
            if n == "box_att2_b" or float(w.abs().max()) == 0.0:
                continue
            err = float((gk[n] - w).abs().mean() / w.abs().mean())
            assert err <= 1e-4, (s, n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("decoder,soft_and", [("bilinear", False),
                                              ("box", False),
                                              ("bibox", True)])
def test_cuda_gqe_server_matches_cpu(decoder, soft_and):
    """One ``QueryServer`` dispatch per structure on the card against the
    same server on the CPU: the same top-10 ids, scores within 1e-4 (the
    ``gqe.serve`` recheck of chip_smoke.py)."""
    import copy

    from mpqe_tpu_torch.data.sampler import QuerySampler
    from mpqe_tpu_torch.serve import QueryServer

    dev = _cuda()
    kg = _gqe_kg()
    cfg, model = _gqe_model(decoder, dev, soft_and=soft_and, seed=2)
    cpu_server = QueryServer(copy.deepcopy(model).to("cpu"), cfg,
                             kg.entity_mode, device="cpu")
    server = QueryServer(model, cfg, kg.entity_mode, device=dev)
    sampler = QuerySampler(kg, seed=3)
    queries = [q for s in STRUCTURE_NAMES
               for q in sampler.sample_queries(s, 12, n_neg=1)]
    got, want = server.answer(queries), cpu_server.answer(queries)
    for q, a, w in zip(queries, got, want):
        np.testing.assert_array_equal(a.entity_ids, w.entity_ids)
        np.testing.assert_allclose(a.scores, w.scores, rtol=0, atol=1e-4)
        assert (kg.entity_mode[a.entity_ids] == q.formula.target_mode).all()


# ------------------------------------------- cfg.dtype = bfloat16 (K1-K3)


def _bf16(cfg, model):
    """The bf16 model of the same parameters and its config."""
    import copy
    import dataclasses

    return (dataclasses.replace(cfg, dtype=torch.bfloat16),
            copy.deepcopy(model).to(torch.bfloat16))


@pytest.mark.cuda
def test_cuda_k3_bf16_store():
    """K3 at ``cfg.dtype = bfloat16``: the bf16 model's output through the
    kernel's bf16 store equals its own f32 output rounded to bf16 (round
    to nearest even), bit for bit; that f32 output under ``multi_gate``
    against the plain version; a repeat launch bit-equal."""
    dev = _cuda()
    cfg, model = _model(128, 16, dev)
    cfg16, model16 = _bf16(cfg, model)
    ops = tff.prepare_fused_multi(model16, cfg16)
    assert ops.ent.dtype == torch.bfloat16
    assert ops.ent.data_ptr() == model16.emb.ent.data_ptr()
    for structure in STRUCTURE_NAMES:
        L = tm.num_steps(cfg, structure)
        for B in (1, 20, 1000):
            args = _inputs(structure, B, dev, seed=B + 1)
            before = tff.fused_tgt_forward_multi.launches
            with torch.no_grad():
                got, acts = tff.fused_tgt_forward_multi_layers(
                    model16, cfg16, structure, *args, operands=ops)
                out16 = tff.fused_tgt_forward_multi(model16, cfg16,
                                                    structure, *args,
                                                    operands=ops)
                again = tff.fused_tgt_forward_multi(model16, cfg16,
                                                    structure, *args,
                                                    operands=ops)
                gate = tff.multi_gate(cfg16, structure, ops, args, got, acts)
            torch.cuda.synchronize()
            assert tff.fused_tgt_forward_multi.launches == before + 3 * L
            assert got.dtype == torch.float32
            assert out16.dtype == torch.bfloat16
            assert torch.equal(out16.view(torch.int16),
                               got.to(torch.bfloat16).view(torch.int16))
            assert torch.equal(out16.view(torch.int16),
                               again.view(torch.int16))
            assert gate["ok"], (structure, B, gate)


@pytest.mark.cuda
@pytest.mark.parametrize("backward", ["xla", "pallas"])
def test_cuda_k1_k2_bf16(backward):
    """K1 / K2 at ``cfg.dtype = bfloat16``: the output is bf16, equal to
    K1's f32 output on the same bf16 parameters rounded (``out_bf16``),
    and that f32 output under ``chain_gate`` against the plain version;
    every parameter gradient comes back in bf16, for ``pallas`` (K2)
    within ``PARAM_GRAD_MEAN_BY_DEPTH`` (mean form, per leaf) of the plain
    K2's, which its control (one basis's gradient moved) fails."""
    import dataclasses

    dev = _cuda()
    cfg, model = _model(128, 16, dev)
    cfg16, model16 = _bf16(cfg, model)
    cfg32 = dataclasses.replace(cfg16, dtype=torch.float32)
    for structure in STRUCTURE_NAMES:
        args = _shared_inputs(structure, 1000, dev, seed=7)
        g = torch.randn((1000, 128), device=dev,
                        generator=torch.Generator(dev).manual_seed(7)).to(
                            torch.bfloat16)
        with torch.no_grad():
            f32_out = tff.fused_tgt_forward(model16, cfg32, structure, *args)
            plain = tff.fused_tgt_forward_reference(model16, cfg32,
                                                    structure, *args)
        L = tm.num_steps(cfg, structure)
        assert tff.chain_gate(f32_out, plain, L)["ok"], structure
        q = tm.encode_dense_fused(model16, cfg16, structure, *args, None,
                                  backward)
        assert q.dtype == torch.bfloat16
        assert torch.equal(q.detach().view(torch.int16),
                           f32_out.to(torch.bfloat16).view(torch.int16))
        params = list(model16.named_parameters())
        grads = torch.autograd.grad(q, [p for _, p in params], g,
                                    allow_unused=True)
        for (name, p), gr in zip(params, grads):
            assert gr is None or gr.dtype == torch.bfloat16, name
        if backward != "pallas":
            continue
        want, _, _ = tff.fused_tgt_backward_reference(
            model16, cfg16, structure, *args, None, g)
        got = {name: (torch.zeros_like(p) if gr is None else gr)
               for (name, p), gr in zip(params, grads)}
        err = tff.param_grad_mean_err(got, want)
        assert err <= tff.PARAM_GRAD_MEAN_BY_DEPTH[L], (structure, err)
        ctrl = tff.param_grad_mean_err(
            tff.param_grad_control(got, want, L), want)
        assert ctrl > tff.PARAM_GRAD_MEAN_BY_DEPTH[L], (structure, ctrl)


@pytest.mark.cuda
def test_cuda_quantized_scores_match_cpu():
    """The rank product on the card: int8 equal to the CPU's (exact int32
    sums; batches under 17 rows padded for ``torch._int_mm``), bf16 and
    f32 within 1e-5 (sum order)."""
    from mpqe_tpu_torch.parallel import rank_shard as trs

    dev = _cuda()
    gen = torch.Generator().manual_seed(0)
    ent = torch.randn((4096, 128), generator=gen)
    ent = ent / ent.norm(dim=1, keepdim=True)
    for B in (1, 16, 17, 256):
        q = torch.randn((B, 128), generator=gen)
        q = q / q.norm(dim=1, keepdim=True)
        for td in ("int8", "bfloat16", "float32"):
            t = trs.quantize_rows(ent, td)
            want = trs.quantized_scores(q, t.t(), td)
            got = trs.quantized_scores(q.to(dev), t.to(dev).t(), td).cpu()
            assert got.dtype == torch.float32 and got.shape == (B, 4096)
            if td == "int8":
                assert torch.equal(got, want), B
            else:
                assert float((got - want).abs().max()) <= 1e-5, (B, td)


# ------------------------------------------- the training host path (card)
def _host_path_stores():
    from mpqe_tpu_torch.data.sampler import QuerySampler, make_random_kg
    from mpqe_tpu_torch.data.store import build_stores
    from mpqe_tpu_torch.queries import group_queries_by_formula

    kg = make_random_kg(n_entities=N_ENT, n_modes=N_MODES, n_base_rels=133,
                        n_triples=40_000, seed=3)
    s = QuerySampler(kg, seed=3)
    qs = []
    for st in ("1-chain", "2-chain", "3-chain_inter", "2-inter"):
        qs += s.sample_queries(st, 300, n_neg=8, n_hard_neg=8)
    return build_stores(group_queries_by_formula(qs), kg=kg)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_cuda_pipeline_copies_equal_host_batches(k):
    """Batches copied on the pipeline's own stream (pinned, non_blocking,
    an event per batch) equal the host pipeline's batches of the same
    seed, read on the consumer's stream after a long kernel queued ahead
    of each read (a missing wait_event or record_stream shows as a stale
    or torn batch)."""
    from mpqe_tpu_torch.data.pipeline import ARRAY_FIELDS, BatchPipeline

    dev = _cuda()
    stores = _host_path_stores()
    kw = dict(batch_size=512, n_neg=8, seed=5, prefetch=3, steps_per_call=k)
    with BatchPipeline(stores, **kw) as host_pipe:
        host = [next(host_pipe) for _ in range(24)]
    a = torch.randn((2048, 2048), device=dev)
    with BatchPipeline(stores, device=dev, **kw) as pipe:
        for want in host:
            for _ in range(4):  # keep the consumer's stream busy
                a = torch.tanh(a @ a * 1e-3)
            got = next(pipe)
            assert got.structure == want.structure
            for f in ARRAY_FIELDS:
                t = getattr(got, f)
                assert t.is_cuda, f
                ref = torch.from_numpy(getattr(want, f)).to(dev)
                assert torch.equal(t, ref), f
            del got
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_multistep_and_prefetch_match_single_steps():
    """On the card through K1/K2, within 1e-4 (entity gradients are
    summed with index_add_ atomics, so bits may differ): K = 4 steps in
    one call give the losses of 4 single steps on the same batches, and
    ``run_train`` with a prefetching pipeline the losses of the same run
    without one; K1 and K2 launch once a step."""
    from mpqe_tpu_torch.data.pipeline import BatchPipeline
    from mpqe_tpu_torch.ops import fused_fwd as ff
    from mpqe_tpu_torch.train import loop as tl

    dev = _cuda()
    stores = _host_path_stores()
    cfg = tm.MPQEConfig(n_entities=N_ENT, n_modes=N_MODES, n_rels=N_RELS,
                        embed_dim=128, n_layers=3, num_bases=16)

    def loss_fn(*a):
        return tm.dense_batch_loss_kernel_fused_fwd(*a, backward="pallas")

    with BatchPipeline(stores, 512, 8, seed=1, steps_per_call=4) as pipe:
        stacked = next(pipe)
    losses = []
    for multi in (True, False):
        tc = tl.TrainConfig(lr=0.01)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = tl.init_train_state(gen, cfg, tc, device=dev)
        if multi:
            step = tl.make_multistep_train_step(cfg, state.optimizer,
                                                loss_fn)
            losses.append(tl.run_multistep_stacked(step, state, stacked))
        else:
            step = tl.make_train_step(cfg, state.optimizer, loss_fn)
            losses.append([tl.run_step(step, state, b) for b in [
                dataclasses.replace(stacked, **{
                    f: getattr(stacked, f)[i] for f in tl.BATCH_FIELDS})
                for i in range(4)]])
    for a, b in zip(*losses):
        assert abs(a - b) <= 1e-4 * abs(b), losses

    def run(prefetch, k):
        tc = tl.TrainConfig(lr=0.01, batch_size=512, n_neg=8, max_steps=16,
                            seed=4)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = tl.init_train_state(gen, cfg, tc, device=dev)
        log = []
        ff.fused_tgt_forward.launches = ff.fused_tgt_backward.launches = 0
        tl.run_train(state, cfg, tc, None, train_stores=stores,
                     batch_loss_fn=loss_fn, log_fn=log.append,
                     prefetch=prefetch, steps_per_call=k)
        return log, (ff.fused_tgt_forward.launches,
                     ff.fused_tgt_backward.launches)

    multi, n_multi = run(2, 4)
    sync, n_sync = run(0, 4)
    assert n_multi == n_sync == (16, 16)
    assert [r["structure"] for r in multi] == [r["structure"] for r in sync]
    for a, b in zip(multi, sync):
        assert a["k"] == 4
        for key in ("loss", "loss_mean_k"):
            assert abs(a[key] - b[key]) <= 1e-4 * abs(b[key]), (a, b)


# ------------------------------------------------------------------
# The sharded entity table on parts of the card
# ------------------------------------------------------------------
def _card_mesh(dev, shape):
    from mpqe_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))


@pytest.mark.cuda
def test_cuda_k3_from_the_compact_anchor_table():
    """K3 over a row-sharded table (each call's anchor rows gathered from
    their owner blocks into a compact table): the bits of K3 over the
    model's own table, in one launch a layer."""
    from mpqe_tpu_torch.parallel import rank_shard as trs
    from mpqe_tpu_torch.parallel import sharding as tsh

    dev = _cuda()
    cfg, model = _model(128, 16, dev)
    sharded = trs.shard_encode_params(model, _card_mesh(dev, (1, 4)))
    ops = tff.prepare_fused_multi(model, cfg)
    ops_s = tff.prepare_fused_multi(sharded, cfg)
    assert isinstance(ops_s.ent, tsh.RowShardedTable)
    for structure in STRUCTURE_NAMES:
        args = _inputs(structure, 256, dev, seed=3)
        with torch.inference_mode():
            want = tff.fused_tgt_forward_multi(model, cfg, structure, *args,
                                               operands=ops)
            before = tff.fused_tgt_forward_multi.launches
            got = tff.fused_tgt_forward_multi(sharded, cfg, structure,
                                              *args, operands=ops_s)
        assert tff.fused_tgt_forward_multi.launches - before == \
            tm.num_steps(cfg, structure)
        assert torch.equal(got, want), structure


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_sharded_server_matches_unsharded(table_dtype):
    """``ShardedQueryServer`` on 4 parts of the card against the unsharded
    server of the same table dtype: ids equal, scores within 1e-4 (the
    rank products' sum order per block)."""
    from mpqe_tpu_torch.data.sampler import QuerySampler, make_random_kg
    from mpqe_tpu_torch.serve import QueryServer, ShardedQueryServer

    dev = _cuda()
    kg = make_random_kg(n_entities=N_ENT, n_modes=N_MODES,
                        n_base_rels=N_RELS // 2, n_triples=20000, seed=0)
    cfg, model = _model(128, 16, dev)
    dense = QueryServer(model, cfg, kg.entity_mode, device=dev,
                        table_dtype=table_dtype)
    sharded = ShardedQueryServer(model, cfg, kg.entity_mode,
                                 _card_mesh(dev, (1, 4)),
                                 table_dtype=table_dtype)
    s = QuerySampler(kg, seed=2)
    req = [q for st in STRUCTURE_NAMES for q in s.sample_queries(st, 8,
                                                                 n_neg=1)]
    a = sharded.answer(req, k=10)
    b = dense.answer(req, k=10)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.entity_ids, y.entity_ids)
        np.testing.assert_allclose(x.scores, y.scores, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_spmd_step_matches_single_device_step():
    """3 SGD steps of the data-parallel step on a (2, 2) mesh of the
    card, the table row-sharded, against the single-device step from the
    same initial parameters: losses within 1e-4 relative, each
    parameter's change within 1e-4 mean-normalized per leaf (the gathers'
    gradients sum by atomics; SGD's change is the gradients' sum, so a
    gradient reduced twice fails), and a leaf that no structure reaches
    unchanged in both."""
    import functools

    from mpqe_tpu_torch.data.batcher import DenseQueryBatch
    from mpqe_tpu_torch.parallel import spmd
    from mpqe_tpu_torch.train import loop as tl

    dev = _cuda()
    cfg, _ = _model(128, 16, dev)
    tc = tl.TrainConfig(lr=1.0, optimizer="sgd", batch_size=256, n_neg=4)
    single = tl.init_train_state(torch.Generator(device=dev).manual_seed(1),
                                 cfg, tc, device=dev)
    one = tl.make_train_step(cfg, single.optimizer)
    init = {k: v.clone() for k, v in single.model.state_dict().items()}
    mesh = _card_mesh(dev, (2, 2))
    init_fn, step = spmd.make_spmd_train_step(cfg, tc, mesh)
    state = init_fn(torch.Generator(device=dev).manual_seed(1))
    for n, v in state.model.state_dict().items():
        assert torch.equal(v, init[n]), n
    rng = np.random.default_rng(0)
    for structure in ("1-chain", "2-inter", "3-chain_inter"):
        spec = STRUCTURES[structure]
        b = DenseQueryBatch(
            structure=structure, n_queries=200,
            node_entity=rng.integers(0, N_ENT, (256, spec.n_nodes)).astype(
                np.int32),
            node_mode=rng.integers(0, N_MODES, (256, spec.n_nodes)).astype(
                np.int32),
            edge_rel=rng.integers(0, N_RELS, spec.n_edges).astype(np.int32),
            edge_norm=np.ones(spec.n_edges, np.float32),
            target=rng.integers(0, N_ENT, 256).astype(np.int32),
            negatives=rng.integers(0, N_ENT, (256, 4)).astype(np.int32),
            neg_mask=np.ones((256, 4), np.float32),
            query_mask=(np.arange(256) < 200).astype(np.float32))
        la = tl.run_step(one, single, b)
        lb = tl.run_step(step, state, b, functools.partial(spmd.put_batch,
                                                           mesh))
        assert abs(la - lb) <= 1e-4 * abs(la), (la, lb)
    got, want = state.model.state_dict(), single.model.state_dict()
    for n, w in want.items():
        dw, dg = w - init[n], got[n] - init[n]
        if not bool((dw != 0).any()):  # a leaf no structure reached
            assert not bool((dg != 0).any()), n
            continue
        err = float((dg - dw).abs().mean() / dw.abs().mean())
        assert err <= 1e-4, (n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name,consts", [
    ("kernel_smoke", {}),
    ("eval_bench", dict(N_ENTITIES=20_000)),
    ("embed_scatter_exp", dict(N=20_000, B=4096)),
])
def test_cuda_tools_run_on_the_card(name, consts, monkeypatch, capsys):
    """``kernel_smoke`` (every kernel against its oracles at the
    reference check's shapes) and one tool of each group, the tools'
    loops cut short, exit 0 on the card with device times recorded."""
    import importlib
    import json

    from mpqe_tpu_torch.tools import probe_common

    _cuda()
    tool = importlib.import_module(f"mpqe_tpu_torch.tools.{name}")
    for k, v in consts.items():
        monkeypatch.setattr(tool, k, v)
    monkeypatch.setattr(probe_common, "LOOP", dict(
        n_small=1, n_large=3, samples=1, profile=1))
    assert tool.main(["--device", "cuda"]) == 0
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert records and all(r.get("ok", True) for r in records)
    if name != "kernel_smoke":
        assert all(r["device_ms"] > 0 for r in records)


@pytest.mark.cuda
def test_cuda_two_processes_equal_one_process():
    """Two processes on the card, each holding half of the parts (gloo
    for the host, CUDA IPC for the blocks): ``chip_smoke.py``'s
    ``multihost.halo`` (the halo step for ``halo_ring`` and
    ``halo_gather`` at the flagship width, ranks bit-equal, losses and
    SGD changes equal to one process within ``MULTIHOST_TOL`` /
    ``SPMD_TOL``) and ``kernel.ring.multiprocess`` (K8 at P = 2 and 4
    bit-equal to one process with its sender delayed, ``ring_gate``
    against its plain version, the skipped-counter control different)."""
    import subprocess
    import sys

    import chip_smoke
    from mpqe_tpu_torch.ops import rgcn_fused, ring

    _cuda()
    chip_smoke.SMI["line"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    ring._kernel()
    rgcn_fused._kernel()
    assert chip_smoke.phase_multiprocess(torch.device("cuda")) > 0


_SILENT_PEER = r"""
import sys, time
import torch
sys.path.insert(0, sys.argv[3])
from mpqe_tpu_torch.parallel import multihost
rank = int(sys.argv[1])
multihost.initialize("127.0.0.1:" + sys.argv[2], 2, rank, backend="gloo",
                     device="cuda", timeout_s=5)
if rank == 1:
    time.sleep(30)
    sys.exit(0)
t0 = time.perf_counter()
try:
    multihost.exchange([torch.ones(3, device="cuda")], "cuda", "silent")
except Exception as e:
    print("RAISED", type(e).__name__, time.perf_counter() - t0, flush=True)
    sys.exit(3)
"""


@pytest.mark.cuda
def test_cuda_transport_refusals_and_a_silent_peer():
    """A CUDA tensor never goes through the gloo transport (it raises),
    and an exchange of CUDA tensors whose peer never sends raises after
    the group's timeout instead of hanging."""
    import os
    import socket
    import subprocess
    import sys

    from mpqe_tpu_torch.parallel import multihost

    _cuda()
    t = torch.ones(3, device="cuda")
    with pytest.raises(ValueError, match="gloo transport takes CPU"):
        multihost._gloo_exchange([t], [1, 1], (3,), torch.float32)
    with pytest.raises(ValueError, match="handed a tensor on cuda"):
        multihost.exchange([t], "cpu")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SILENT_PEER, str(r), str(port), repo],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[0].returncode == 3, outs[0]
    assert "RAISED" in outs[0][0]


def _cards(n):
    """The first ``n`` visible cards, ``chip_smoke.SMI`` set and the K8
    libraries built; skips below ``n`` cards."""
    import subprocess

    import chip_smoke
    from mpqe_tpu_torch.ops import rgcn_fused, ring

    _cuda()
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    chip_smoke.SMI["line"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ring._kernel()
    rgcn_fused._kernel()
    return [torch.device("cuda", i) for i in range(
        min(torch.cuda.device_count(), chip_smoke.MULTICARD_MAX))]


@pytest.mark.cuda
def test_cuda_one_process_over_cards_matches_one_card(tmp_path):
    """``chip_smoke.py``'s ``multicard.spmd``, ``multicard.halo`` and
    ``multicard.ring`` over every visible card (two at least): the spmd
    step and the halo step against the same meshes on parts of cuda:0,
    K8 bit-equal to the one-card K8 with its copies delayed, under
    ``ring_gate``, its control different, peer access on."""
    import chip_smoke
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    cards = _cards(2)
    cfg = mpqe_mod.MPQEConfig(**chip_smoke.FLAGSHIP)
    chip_smoke.multicard_spmd(cards)
    chip_smoke.multicard_halo(cards, str(tmp_path))
    launches, figures = chip_smoke.multicard_ring(cfg, cards)
    assert launches > 0 and set(figures) == {2, len(cards)}


@pytest.mark.cuda
def test_cuda_peer_copy_refused_without_peer_access(monkeypatch):
    """A copy between two cards that ``can_device_access_peer`` says
    cannot reach each other raises instead of going through the host."""
    from mpqe_tpu_torch.parallel import ipc

    cards = _cards(2)
    a = torch.ones(4, device=cards[0])
    b = torch.zeros(4, device=cards[1])
    monkeypatch.setattr(ipc, "_PEERS", set())
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda x, y: False)
    with pytest.raises(RuntimeError, match="no peer access"):
        ipc.copy_between(b, a, torch.cuda.current_stream(cards[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["nccl", "procs_x_cards"])
def test_cuda_processes_on_their_own_cards(tmp_path, which):
    """``multicard.nccl`` (two processes under NCCL on cuda:0 and cuda:1:
    the spmd step, the halo step and K8) and ``multicard.procs_x_cards``
    (two processes of two cards each, four cards): equal to one process
    as the one-card pair is."""
    import chip_smoke

    cards = _cards(2 if which == "nccl" else 4)
    spmd = which == "nccl"
    each = (["cuda:0", "cuda:1"] if spmd
            else ["cuda:0,cuda:1", "cuda:2,cuda:3"])
    chip_smoke.mp_pair(cards[0], str(tmp_path), "nccl", each, spmd=spmd)
    bad, launches = chip_smoke.mp_compare(
        str(tmp_path), ("spmd", "halo", "ring"), ("nccl", "nccl"),
        spmd=spmd)
    assert not bad and launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["multinode", "multinode.mixed.procs",
                                   "multinode.mixed.cards"])
def test_cuda_two_node_groups_equal_one_process(tmp_path, label):
    """``chip_smoke.py``'s ``multinode`` runs: two node groups of this host
    (two ``torchrun --nnodes 2`` launches over their own cards, NCCL over
    sockets between them): the exchange cases, the spmd step (2 nodes x
    1 process), the halo step and K8 equal to one process as the pairs
    are, every process on the node it was launched on, no CUDA IPC handle
    opened across nodes, NCCL's network transport for every connection.
    Skips below the cards the run needs (2, or 4 for the mixed runs)."""
    import os

    import numpy as np_

    import chip_smoke

    _, node_cards, nproc, cards, spmd, need = next(
        r for r in chip_smoke.MULTINODE_RUNS if r[0] == label)
    dev = _cards(need)[0]
    wall, via, _ = chip_smoke.mp_nodes(dev, str(tmp_path), node_cards,
                                       nproc, cards, spmd)
    world = 2 * nproc
    bad, launches = chip_smoke.mp_compare(
        str(tmp_path), ("spmd", "halo", "ring"), (label, label), spmd=spmd,
        world=world)
    assert not bad and launches > 0
    for r in range(world):
        with np_.load(os.path.join(str(tmp_path), f"k8_rank{r}.npz")) as z:
            assert z["nodes"].tolist() == [q // nproc for q in range(world)]
            assert all(q // nproc == r // nproc for q in z["opened_from"])
    assert via and all(k.startswith("NET") for k in via), via
