"""The CUDA kernels K1, K2, K3 and the served path on the card, against
their plain versions.  Needs an NVIDIA GPU: every test here skips itself
without one.

This file imports no JAX (the machine with the card has none), so it
runs there without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerance: each kernel output vs its plain version max|diff| / max|ref|
<= 1e-4 (for K2 per output leaf); both sum in the same order, so the
expected difference is 0.
"""

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
    dev = _cuda()
    cfg, model = _model(d, nb, dev)
    ops = tff.prepare_fused_multi(model, cfg)
    for structure in STRUCTURE_NAMES:
        for B in (1, 20, 1000):
            args = _inputs(structure, B, dev, seed=B)
            before = tff.fused_tgt_forward_multi.launches
            with torch.no_grad():
                got = tff.fused_tgt_forward_multi(model, cfg, structure,
                                                  *args, operands=ops)
                want = tff.fused_tgt_forward_multi_reference(
                    model, cfg, structure, *args, operands=ops)
            torch.cuda.synchronize()
            assert tff.fused_tgt_forward_multi.launches == before + 1
            assert got.shape == (B, d) and got.device.type == "cuda"
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= 1e-4, (structure, B, err)


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
    cfg, model = _model(1000, 1, dev)  # d_pad 1024: 4 slots need 320 KB
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
    assert tff.fused_tgt_forward_multi.launches == before + len(STRUCTURE_NAMES)
    for s in STRUCTURE_NAMES:
        idx = [i for i, q in enumerate(queries) if q.formula.structure == s]
        _, *arrays = server._pack([queries[i] for i in idx])
        ne, nm, er, en, tgt_mode = [torch.from_numpy(a).to(dev)
                                    for a in arrays]
        with torch.no_grad():
            q = tff.fused_tgt_forward_multi_reference(
                model, cfg, s, ne, nm, er, en, operands=server._k3)
            q = tm._l2_normalize(q)
            scores = q @ server._ent_norm_t
            scores.masked_fill_(server._mode_dev[None, :] != tgt_mode[:, None],
                                float("-inf"))
            vals, ids = top_k(scores, 10)
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
    dev = _cuda()
    cfg, model = _model(d, nb, dev)
    for structure in STRUCTURE_NAMES:
        for B in (1, 20, 1000, 5000):
            args = _shared_inputs(structure, B, dev, seed=B)
            g = torch.randn((B, d), device=dev,
                            generator=torch.Generator(dev).manual_seed(B))
            f0, b0 = tff.fused_tgt_forward.launches, \
                tff.fused_tgt_backward.launches
            with torch.no_grad():
                got = tff.fused_tgt_forward(model, cfg, structure, *args)
                want = tff.fused_tgt_forward_reference(model, cfg, structure,
                                                       *args)
            dp, den, _ = tff.fused_tgt_backward(model, cfg, structure,
                                                *args, None, g)
            dp_r, den_r, _ = tff.fused_tgt_backward_reference(
                model, cfg, structure, *args, None, g)
            torch.cuda.synchronize()
            assert tff.fused_tgt_forward.launches == f0 + 1
            assert tff.fused_tgt_backward.launches == b0 + 1
            assert got.shape == (B, d) and got.device.type == "cuda"
            assert _rel(got, want) <= 1e-4, (structure, B, _rel(got, want))
            for name, t in dp_r.items():
                if t.abs().max() > 0:
                    e = _rel(dp[name], t)
                    assert e <= 1e-4, (structure, B, name, e)
            assert _rel(den, den_r) <= 1e-4, (structure, B)


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
    for x, ws, bs in bad:
        with pytest.raises(ValueError):
            tff._chain_forward(x, ws, bs, 16)
