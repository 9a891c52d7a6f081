"""The port's AM-scale quality tool (``mpqe_tpu_torch/tools/
am_scale_quality.py``) against the reference tool on the CPU: the numpy
parts array for array (``dedup_against``, ``RuleOracle``,
``build_hard_bank``); the losses and their gradients within 1e-5 of the
reference's closures written out in JAX below (per-query negatives, the
shared sweep uniform and self-adversarial, the hard term, the GQE arms);
``_apr_percentiles`` / ``roc_auc`` equal; the trajectory bit-equal across
``--steps_per_call``; one small run per arm of
``tests/test_am_scale_tool.py``."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.models import gqe as jgqe
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.queries import STRUCTURES
from mpqe_tpu.train import evaluation as jeval
from mpqe_tpu_torch import convert
from mpqe_tpu_torch.data import native as tnative
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.models import gqe as tgqe
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.tools import am_scale_quality as tool
from mpqe_tpu_torch.train import evaluation as teval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--kg", "band_seg", "--entities", "4000",
         "--edge_bank", "50000", "--batch_size", "64", "--burn_in_steps",
         "20", "--steps", "40", "--steps_per_call", "20", "--train_queries",
         "4000", "--val_queries", "128", "--n_neg_eval", "16",
         "--n_hard_eval", "8", "--eval_oracle", "--dim", "16", "--layers",
         "2", "--bases", "4"]


def _ref_tool():
    spec = importlib.util.spec_from_file_location(
        "_ref_am_scale_quality",
        os.path.join(REPO, "tools", "am_scale_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _ref_tool()


@pytest.fixture(scope="module")
def kg_and_queries():
    """The band_seg KG from both packages (bit-equal) and 3-chain_inter /
    2-inter queries from the port's C++ sampler."""
    kw = dict(n_entities=2000, n_modes=4, n_base_rels=6, seed=0,
              variant="band_seg", seg_width=8)
    jkg, tkg = jsamp.make_rule_kg(**kw), tsamp.make_rule_kg(**kw)
    for f in ("heads", "rels", "tails", "entity_mode"):
        np.testing.assert_array_equal(getattr(jkg, f), getattr(tkg, f))
    assert tnative.ensure_built()
    csr = tnative.build_incoming_csr_native(tkg)
    qs = {s: tnative.sample_queries_native(tkg, s, 300, n_neg=4, seed=1,
                                           csr=csr)
          for s in ("3-chain_inter", "2-inter", "2-chain")}
    return jkg, tkg, qs


def test_dedup_oracle_and_hard_bank_equal_the_reference(ref, kg_and_queries):
    jkg, tkg, qs = kg_and_queries
    t, v = qs["3-chain_inter"], qs["2-inter"]
    np.testing.assert_array_equal(
        tool.dedup_against(t["entities"], t["rels"], t["entities"][::2],
                           t["rels"][::2]),
        ref.dedup_against(t["entities"], t["rels"], t["entities"][::2],
                          t["rels"][::2]))
    keep = tool.dedup_against(t["entities"][:150], t["rels"][:150],
                              t["entities"], t["rels"])
    assert keep[:150].sum() == 0 and keep[150:].any()
    to, ro = tool.RuleOracle(tkg), ref.RuleOracle(jkg)
    np.testing.assert_array_equal(to.key, ro.key)
    np.testing.assert_array_equal(to.tails, ro.tails)
    for s, q in (("3-chain_inter", t), ("2-inter", v),
                 ("2-chain", qs["2-chain"])):
        spec = STRUCTURES[s]
        for i in range(0, 40, 3):
            np.testing.assert_array_equal(
                to.answers(spec, q["entities"][i], q["rels"][i]),
                ro.answers(spec, q["entities"][i], q["rels"][i]))
            np.testing.assert_array_equal(
                to.hard_negatives(spec, q["entities"][i], q["rels"][i], 6,
                                  np.random.default_rng(i)),
                ro.hard_negatives(spec, q["entities"][i], q["rels"][i], 6,
                                  np.random.default_rng(i)))
        got = tool.build_hard_bank(to, spec, q["entities"][:600],
                                   q["rels"][:600], 4, seed=17, procs=1)
        want = ref.build_hard_bank(ro, spec, q["entities"][:600],
                                   q["rels"][:600], 4, seed=17, procs=1)
        np.testing.assert_array_equal(got, want)
        assert tool._POOL_CTX == {}


def test_apr_percentiles_and_roc_auc_equal_the_reference():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=64).astype(np.float32)
    neg = rng.normal(size=(64, 9)).astype(np.float32)
    neg[3, :4] = pos[3]  # ties take half credit
    mask = (rng.random((64, 9)) > 0.2).astype(np.float32)
    mask[5] = 0.0  # a query with no negative is dropped
    np.testing.assert_array_equal(teval._apr_percentiles(pos, neg, mask),
                                  jeval._apr_percentiles(pos, neg, mask))
    assert teval.roc_auc(pos, neg) == jeval.roc_auc(pos, neg)


# ---- the reference's closures (tools/am_scale_quality.py main), in JAX


def _j_pos_neg(p, cfg, gqe, structure, ne, nm, er, tgt, neg):
    if gqe:
        return jgqe.score_pos_neg(p, cfg, structure, ne, er, tgt, neg)
    en = jnp.ones(er.shape, jnp.float32)
    q = jm.encode_dense_multi(p, cfg, structure, ne, nm, er, en)
    ent = p["emb"]["ent"]
    return (jm.score(cfg, q, ent[tgt]),
            jm.score(cfg, q[:, None, :], ent[neg]))


def _j_sweep(cfg, gqe, q, rows):
    if gqe and cfg.decoder == "box":
        return jgqe.box_score_rows(cfg, q, rows)
    if gqe and cfg.decoder == "bibox":
        return jgqe.bibox_score_rows(cfg, q, rows)
    qf, rf = q.astype(jnp.float32), rows.astype(jnp.float32)
    if cfg.scale_scores:
        qf = qf / (jnp.linalg.norm(qf, axis=-1, keepdims=True) + 1e-12)
        rf = rf / (jnp.linalg.norm(rf, axis=-1, keepdims=True) + 1e-12)
    return jnp.dot(qf, rf.T, preferred_element_type=jnp.float32)


def _j_margin_pn(cfg, pos, neg):
    return jnp.mean(jax.nn.relu(cfg.margin - pos[:, None] + neg))


def _j_multi_loss(p, cfg, gqe, structure, ne, nm, er, tgt, neg, shared,
                  self_adv):
    pos, ng = _j_pos_neg(p, cfg, gqe, structure, ne, nm, er, tgt, neg)
    loss = _j_margin_pn(cfg, pos, ng)
    if shared is not None:
        if gqe:
            q = jgqe.encode_dense_multi(p, cfg, structure, ne, nm, er, None)
        else:
            q = jm.encode_dense_multi(p, cfg, structure, ne, nm, er,
                                      jnp.ones(er.shape, jnp.float32))
        rows = p["emb"]["ent"][shared]
        sc = _j_sweep(cfg, gqe, q, rows)
        viol = jax.nn.relu(cfg.margin - pos[:, None] + sc)
        w = (shared[None, :] != tgt[:, None]).astype(viol.dtype)
        if self_adv > 0.0:
            logits = jnp.where(w > 0, self_adv * sc, -jnp.inf)
            p_adv = jax.lax.stop_gradient(jax.nn.softmax(logits, axis=1))
            per_q = jnp.sum(jnp.where(w > 0, p_adv * viol, 0.0), axis=1)
            loss = loss + jnp.mean(per_q)
        else:
            loss = loss + jnp.sum(viol * w) / jnp.maximum(jnp.sum(w), 1.0)
    return loss


def _j_chain_loss(p, cfg, gqe, emode, anchor, r, tgt, neg):
    ne = jnp.stack([anchor, tgt], axis=1)
    return _j_margin_pn(cfg, *_j_pos_neg(p, cfg, gqe, "1-chain", ne,
                                         emode[ne], r[:, None], tgt, neg))


def _j_hard(p, cfg, gqe, structure, hne, hre, hng, emode, hm):
    spec = STRUCTURES[structure]
    hpos, hns = _j_pos_neg(p, cfg, gqe, structure, hne, emode[hne], hre,
                           hne[:, spec.target_slot], jnp.maximum(hng, 0))
    m = (hng >= 0).astype(jnp.float32)
    viol = jax.nn.relu(hm - hpos[:, None] + hns) * m
    return jnp.sum(viol) / jnp.maximum(jnp.sum(m), 1.0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


ARMS = {
    "per_query": ("rgcn", None, 0.0, False),
    "shared_uniform": ("rgcn", None, 0.0, True),
    "shared_self_adv": ("rgcn", None, 1.0, True),
    "hard": ("rgcn", None, 0.0, False),
    "chain": ("rgcn", None, 0.0, False),
    "gqe_bilinear_shared": ("gqe", "bilinear", 0.0, True),
    "gqe_box_shared_self_adv": ("gqe", "box", 0.5, True),
    "gqe_chain": ("gqe", "bilinear", 0.0, False),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_losses_and_gradients_match_the_reference(arm, kg_and_queries):
    jkg, tkg, qs = kg_and_queries
    model_kind, decoder, self_adv, sweep = ARMS[arm]
    gqe = model_kind == "gqe"
    kw = dict(n_entities=tkg.n_entities, n_modes=tkg.n_modes,
              n_rels=tkg.n_rels, embed_dim=16)
    if gqe:
        jcfg = jgqe.GQEConfig(**kw, decoder=decoder, intersection="deepsets")
        tcfg = tgqe.GQEConfig(**kw, decoder=decoder, intersection="deepsets")
        jp = jgqe.init_gqe(jax.random.PRNGKey(3), jcfg)
        model = convert.gqe_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       "cpu")
    else:
        kw.update(n_layers=3, num_bases=4, readout="tgt")
        jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
        jp = jm.init_mpqe(jax.random.PRNGKey(3), jcfg)
        model = convert.model_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         "cpu")
    rng = np.random.default_rng(5)
    s = "3-chain_inter"
    q = qs[s]
    B = 48
    idx = rng.integers(0, q["entities"].shape[0], B)
    ne, er = q["entities"][idx], q["rels"][idx]
    negs = q["negatives"][idx]
    tslot = STRUCTURES[s].target_slot
    emode = tkg.entity_mode.astype(np.int32)
    shared = (rng.integers(0, tkg.n_entities, 32).astype(np.int32)
              if sweep else None)
    if sweep:
        shared[:3] = ne[:3, tslot]  # some candidates are a target: masked
    if arm.endswith("chain"):
        src, rel, dst = tkg.directed_edges()
        e = rng.integers(0, src.shape[0], B)
        args = (emode, src[e], rel[e], dst[e],
                rng.integers(0, tkg.n_entities, (B, 4)).astype(np.int32))

        def jloss(p):
            return _j_chain_loss(p, jcfg, gqe, *map(jnp.asarray, args))

        def tloss():
            return tool.chain_loss(model, tcfg,
                                   *(torch.as_tensor(a).long()
                                     for a in args))
    elif arm == "hard":
        hng = rng.integers(-1, tkg.n_entities, (B, 5)).astype(np.int32)
        hng[:, 0] = np.maximum(hng[:, 0], 0)

        def jloss(p):
            return _j_hard(p, jcfg, gqe, s, jnp.asarray(ne), jnp.asarray(er),
                           jnp.asarray(hng), jnp.asarray(emode), 0.2)

        def tloss():
            t = torch.as_tensor
            return tool.hard_term(model, tcfg, s, t(ne).long(),
                                  t(er).long(), t(hng).long(),
                                  t(emode).long(), 0.2)
    else:
        def jloss(p):
            return _j_multi_loss(
                p, jcfg, gqe, s, jnp.asarray(ne), jnp.asarray(emode[ne]),
                jnp.asarray(er), jnp.asarray(ne[:, tslot]),
                jnp.asarray(negs),
                None if shared is None else jnp.asarray(shared), self_adv)

        def tloss():
            t = torch.as_tensor
            return tool.multi_loss(
                model, tcfg, s, t(ne).long(), t(emode[ne]).long(),
                t(er).long(), t(ne[:, tslot]).long(), t(negs).long(),
                shared=None if shared is None else t(shared).long(),
                self_adv=self_adv)

    want, jgrad = jax.value_and_grad(jloss)(jp)
    got = tloss()
    got.backward()
    got = float(got.detach())
    assert abs(got - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    jg = _flat(jgrad)
    top = max(float(np.abs(v).max()) for v in jg.values())
    for name, p in model.named_parameters():
        g = (p.grad.numpy() if p.grad is not None
             else np.zeros(tuple(p.shape), np.float32))
        if name == "box_att2_b":
            # the box attention's output bias is added to every branch
            # before a softmax over the branches: its exact gradient is
            # 0, and both packages hold rounding only
            assert max(np.abs(g).max(), np.abs(jg[name]).max()) <= \
                1e-6 * top
            continue
        scale = max(float(np.abs(jg[name]).max()), 1e-6)
        err = float(np.abs(g - jg[name]).max()) / scale
        assert err <= 1e-5, (name, err)


def test_trajectory_does_not_depend_on_steps_per_call():
    """Each step's draws are seeded from (seed + 7, step): 60 steps a call
    and 30 give the same losses, bit for bit, and the same result (one
    structure: a mix's round-robin switches structure once a call)."""
    base = ["--device", "cpu", "--kg", "band_seg", "--entities", "2000",
            "--edge_bank", "20000", "--batch_size", "32", "--train_queries",
            "2000", "--val_queries", "64", "--n_neg_eval", "8", "--dim",
            "16", "--layers", "2", "--bases", "4", "--burn_in_steps", "60",
            "--steps", "120", "--train_shared_negs", "16"]
    runs = []
    for k in ("60", "30"):
        lines = []
        result, traj = tool.run(tool.parse_args(base + ["--steps_per_call",
                                                        k]), lines.append)
        runs.append((result, traj, lines))
    (r60, t60, l60), (r30, t30, l30) = runs
    assert len(t60["burn_in"]) == 60 and len(t60["full"]) == 120
    assert t60 == t30
    assert [ln["step"] for ln in l30 if ln["phase"] == "full"] == \
        [30, 60, 90, 120]
    for key in ("apr", "auc_pooled", "val_heldout"):
        assert r60[key] == r30[key]


@pytest.mark.parametrize("extra", [
    [],
    ["--train_shared_negs", "32"],
    ["--train_shared_negs", "32", "--train_self_adv", "1.0",
     "--train_shared_strat"],
    ["--model", "gqe", "--train_shared_negs", "32"],
], ids=["per_query", "uniform_sweep", "strat_self_adv_sweep", "gqe"])
def test_small_run_per_arm(extra):
    lines = []
    res, traj = tool.run(tool.parse_args(SMALL + extra), lines.append)
    phases = [ln["phase"] for ln in lines]
    assert phases[0] == "kg_gen" and phases[-1] == "result"
    assert phases.count("burn_in") == 1 and phases.count("full") == 2
    assert res is lines[-1] and res["kg"] == "band_seg"
    assert res["backend"] == "cpu" and res["peak_mem_bytes"] is None
    assert res["val_heldout"] > 0
    assert np.isfinite(res["apr"]) and 0.0 <= res["apr"] <= 100.0
    assert np.isfinite(res["auc_pooled"])
    assert 0.0 < res["apr_ceiling"] <= 100.0
    assert res["mean_answer_set"] >= 1.0
    assert res["hard_queries"] > 0 and np.isfinite(res["hard_apr"])
    assert all(np.isfinite(traj["burn_in"] + traj["full"]))


def test_cli_hard_negatives_mix_and_weights():
    """As a user runs it: the fork-pool hard bank, a two-structure mix
    with weights and the refusal of an unknown structure weight."""
    cmd = [sys.executable, "-m", "mpqe_tpu_torch.tools.am_scale_quality"]
    proc = subprocess.run(
        cmd + SMALL + ["--structure", "2-chain,2-inter",
                       "--train_shared_negs", "32", "--train_hard_negs",
                       "4", "--hard_bank", "512", "--hard_margin", "0.2",
                       "--hard_start", "0.25", "--structure_weights",
                       "2-chain=2"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [ln["structure"] for ln in lines if ln["phase"] == "hard_bank"] \
        == ["2-chain", "2-inter"]
    res = lines[-1]
    ps = res["per_structure"]
    assert set(ps) == {"2-chain", "2-inter"}
    assert ps["2-chain"]["hard_queries"] == 0
    assert ps["2-inter"]["hard_queries"] > 0
    assert [ln["structure"] for ln in lines if ln["phase"] == "full"] == \
        ["2-chain", "2-chain"]
    proc = subprocess.run(
        cmd + SMALL + ["--structure", "2-chain", "--structure_weights",
                       "not-a-structure=2"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "not in the trained structure set" in proc.stderr
