"""The port's binding to the C++ host runtime (``mpqe_tpu_torch/data/
native.py``) against the JAX package's (``mpqe_tpu/data/native.py``) on
the same inputs: every entry point's output bit for bit (the packer with
hard negatives, the fallback pool and answer sets; the edge store; the
synthetic KG; the incoming-edge CSR; the sampler; the N-Triples parse),
``load_ntriples_kg(native=True)`` against the Python parse, and the
build: from ``cpp/mpqe_host.cpp`` into the port's build directory,
concurrent builds included, with nothing under ``cpp/`` written.
"""

import dataclasses
import gzip
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mpqe_tpu.data import native as jnat
from mpqe_tpu.data import rdf as jrdf
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data import store as jstore
from mpqe_tpu_torch.data import native as tnat
from mpqe_tpu_torch.data import rdf as trdf
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.data import store as tstore
from mpqe_tpu_torch.queries import STRUCTURE_NAMES

REPO = Path(__file__).resolve().parent.parent
BATCH_FIELDS = ("node_entity", "node_mode", "edge_rel", "edge_norm",
                "target", "negatives", "neg_mask", "query_mask")

pytestmark = pytest.mark.skipif(
    not (tnat.ensure_built() and jnat.ensure_built()),
    reason=f"C++ host library not buildable: {tnat.BUILD_ERROR}")


def _same_batches(a, b):
    assert (a.structure, a.n_queries, a.used_hard) == (
        b.structure, b.n_queries, b.used_hard)
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, f)


def _stores(seed=6):
    """Both packages' stores from the same sampled queries, with hard
    negatives."""
    kw = dict(n_entities=150, n_modes=3, n_base_rels=4, n_triples=900,
              seed=23)
    out = []
    for samp, store in ((jsamp, jstore), (tsamp, tstore)):
        kg = samp.make_random_kg(**kw)
        s = samp.QuerySampler(kg, seed=seed)
        qs = []
        for st in ("2-chain", "3-inter_chain", "2-inter"):
            qs += s.sample_queries(st, 40, n_neg=8, n_hard_neg=8)
        grouped = {}
        for q in qs:
            grouped.setdefault(q.formula.structure, {}).setdefault(
                q.formula, []).append(q)
        out.append((kg, store.build_stores(grouped, kg=kg)))
    return out


@pytest.mark.parametrize("use_hard", [False, True], ids=["plain", "hard"])
def test_pack_dense_batch_native_matches_jax(use_hard):
    (_, js), (_, ts) = _stores()
    assert list(js) == list(ts)
    seed = 0
    for s in js:
        for a, b in zip(js[s], ts[s]):
            for pick in (np.arange(a.n_queries)[::-1],
                         np.asarray([0, 0, 1, 3])[:a.n_queries]):
                seed += 1
                pick = pick.astype(np.int64)
                _same_batches(
                    jnat.pack_dense_batch_native(a, pick, 16, 5, seed,
                                                 use_hard),
                    tnat.pack_dense_batch_native(b, pick, 16, 5, seed,
                                                 use_hard))


def test_pack_fallback_pool_and_answer_sets_match_jax():
    """Raw-edge stores: negatives from the same-mode fallback pool,
    excluding each head's answer set; and a tiny pool that forces the
    probe walk and masked slots."""
    kw = dict(n_entities=120, n_modes=3, n_base_rels=4, n_triples=900,
              seed=5)
    js = jstore.stores_from_edges(jsamp.make_random_kg(**kw))["1-chain"]
    ts = tstore.stores_from_edges(tsamp.make_random_kg(**kw))["1-chain"]
    assert len(js) == len(ts)
    rng = np.random.default_rng(0)
    for i, (a, b) in enumerate(zip(js, ts)):
        pick = rng.integers(0, a.n_queries, 12).astype(np.int64)
        _same_batches(jnat.pack_dense_batch_native(a, pick, 16, 6, i),
                      tnat.pack_dense_batch_native(b, pick, 16, 6, i))
    a, b = js[0], ts[0]
    pool = a.fallback_pool[:3]
    a, b = (dataclasses.replace(x, fallback_pool=pool) for x in (a, b))
    for seed in range(4):
        pick = np.zeros(4, np.int64)
        _same_batches(jnat.pack_dense_batch_native(a, pick, 8, 6, seed),
                      tnat.pack_dense_batch_native(b, pick, 8, 6, seed))


@pytest.mark.parametrize("capacity", [None, 700])
def test_build_edge_store_native_matches_jax(capacity):
    rng = np.random.default_rng(1)
    n_e, n_nodes, n_rels = 500, 60, 7
    src = rng.integers(0, n_nodes, n_e).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_e).astype(np.int32)
    rel = rng.integers(0, n_rels, n_e).astype(np.int32)
    a = jnat.build_edge_store_native(src, dst, rel, n_nodes, n_rels,
                                     capacity)
    b = tnat.build_edge_store_native(src, dst, rel, n_nodes, n_rels,
                                     capacity)
    for f in ("src", "dst", "rel", "norm", "rel_ptr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.n_edges, a.n_nodes, a.n_rels) == (b.n_edges, b.n_nodes,
                                                b.n_rels)


def _synthetic():
    kw = dict(n_entities=400, n_modes=3, n_base_rels=5, n_triples=3000,
              seed=11)
    return (jnat.make_synthetic_kg_native(**kw),
            tnat.make_synthetic_kg_native(**kw))


def test_synthetic_kg_and_csr_match_jax():
    a, b = _synthetic()
    for f in ("entity_mode", "rel_domain", "rel_range", "heads", "rels",
              "tails"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.n_entities, a.n_base_rels) == (b.n_entities, b.n_base_rels)
    ca = jnat.build_incoming_csr_native(a)
    cb = tnat.build_incoming_csr_native(b)
    assert set(ca) == set(cb)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], k)


@pytest.mark.parametrize("structure", list(STRUCTURE_NAMES))
def test_sample_queries_native_matches_jax(structure):
    a, b = _synthetic()
    csr = tnat.build_incoming_csr_native(b)
    got = tnat.sample_queries_native(b, structure, 64, 5, seed=3, csr=csr)
    want = jnat.sample_queries_native(a, structure, 64, 5, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    assert (got["entities"][:, 0] >= 0).any()


NT_CASES = {
    "tricky": (
        "<http://a> <http://p> _:b9.\n"
        '<http://a> <http://p> "x"@en.\n'
        "<http://a> <http://p> <http://b>.\n"
        '<http://a> <http://p> "1"^^<http://t>.\n'
        "  <http://ws> <http://p> <http://b> .  \n"
        '<http://a> <http://p> "esc \\" quote" .\n'
        "# a comment\n\n"
        "<http://b> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> "
        "<http://T> .\n").encode(),
    "cr_and_invalid_utf8": (b"<http://a> <http://p> <http://b\xff> .\r\n"
                            b"<http://a> <http://p> <http://b\xfe> .\r\n"
                            b"<http://c> <http://p> \"l\\u00e9\" .\n"),
    "error_line_2": b"<http://a> <http://p> <http://b> .\n<http://a> nope .\n",
}


@pytest.mark.parametrize("case", list(NT_CASES))
def test_parse_ntriples_native_matches_jax(case):
    data = NT_CASES[case]
    outs = []
    for nat, rdf in ((jnat, jrdf), (tnat, trdf)):
        try:
            spo, lit, terms = nat.parse_ntriples_native(data)
            outs.append(("ok", spo, lit, terms))
        except rdf.NTriplesError as e:
            outs.append(("error", str(e)))
    a, b = outs
    assert a[0] == b[0] == ("error" if case.startswith("error") else "ok")
    if a[0] == "error":
        assert a[1] == b[1] and "line 2" in b[1]
        return
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    assert a[3] == b[3]
    # and the port's own Python parser agrees
    text = data.decode("utf-8", "replace").splitlines()
    spo, lit, terms = trdf.intern_statements(trdf.parse_ntriples(text))
    np.testing.assert_array_equal(b[1], spo)
    np.testing.assert_array_equal(b[2], lit)
    assert b[3] == terms


def _write_nt(kg, path):
    lines = [f"<http://s/e{e:04d}> <{trdf.RDF_TYPE}> "
             f"<http://s/M{int(kg.entity_mode[e])}> ."
             for e in range(kg.n_entities)]
    lines += [f"<http://s/e{int(h):04d}> <http://s/r{int(r)}> "
              f"<http://s/e{int(t):04d}> ."
              for h, r, t in zip(kg.heads, kg.rels, kg.tails)]
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("native", [True, None])
def test_load_ntriples_kg_native_equals_python(native, tmp_path):
    src = tsamp.make_random_kg(n_entities=150, n_modes=3, n_base_rels=5,
                               n_triples=1200, seed=13)
    nt = str(tmp_path / "kg.nt.gz")
    _write_nt(src, nt)
    got = trdf.load_ntriples_kg(nt, native=native, min_rel_count=2)
    want = trdf.load_ntriples_kg(nt, native=False, min_rel_count=2)
    ref = jrdf.load_ntriples_kg(nt, native=True, min_rel_count=2)
    for other in (want, ref):
        for f in ("entity_mode", "rel_domain", "rel_range", "heads", "rels",
                  "tails"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(other, f), f)
        assert got.rel_names == other.rel_names
        assert got.mode_names == other.mode_names


def _tree_digest(d: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.iterdir())}


def test_concurrent_builds_write_nothing_under_cpp(tmp_path):
    """Three processes build the library at once into a fresh directory:
    each loads it, one file results (no half-written or temporary file
    is left), and ``cpp/`` is unchanged, file for file."""
    before = _tree_digest(REPO / "cpp")
    build = tmp_path / "build"
    code = ("import sys; from pathlib import Path; "
            "from mpqe_tpu_torch.data import native as n; "
            f"n.BUILD_DIR = Path({str(build)!r}); "
            "ok = n.ensure_built(); print(ok, n.BUILD_ERROR); "
            "sys.exit(0 if ok and n.pack_dense_batch_native else 1)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert [p.name for p in build.iterdir()] == [
        tnat.library_path().name]
    assert _tree_digest(REPO / "cpp") == before
