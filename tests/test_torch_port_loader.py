"""The port's data loader, raw-edge stores and training-data sampler
against the JAX package on the CPU: npz and GQE graph pickles, query
pickles, the generalization split, ``make_rule_kg``, ``edge_queries`` /
``all_edge_queries`` and ``stores_from_edges``.

Everything here is numpy and Python on both sides, so every comparison is
exact: equal arrays, equal queries, equal buckets (no tolerance).  Files
written by either package are read by the other.  Sizes are the JAX
tests' (``tests/test_loader.py``, ``tests/test_sampler.py``).
"""

import dataclasses
import pickle

import numpy as np
import pytest

from mpqe_tpu.data import loader as jload
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data import store as jstore
from mpqe_tpu.queries import STRUCTURES as JSTRUCTURES
from mpqe_tpu_torch.data import loader as tload
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.data import store as tstore
from mpqe_tpu_torch.queries import STRUCTURES as TSTRUCTURES

KG_FIELDS = ("entity_mode", "rel_domain", "rel_range", "heads", "rels",
             "tails")
# the JAX tests' KGs: test_loader.py's fixture and its 12-relation one
# (lexicographic name order permutes base ids and flips directions)
KGS = {
    "loader": dict(n_entities=80, n_modes=3, n_base_rels=4, n_triples=600,
                   seed=13),
    "rel12": dict(n_entities=120, n_modes=3, n_base_rels=12, n_triples=900,
                  seed=7),
}
SIDES = {"jax": (jload, jsamp), "port": (tload, tsamp)}


def _kg(side, name):
    return SIDES[side][1].make_random_kg(**KGS[name])


def assert_kgs_equal(a, b):
    for f in KG_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert (a.n_entities, a.n_base_rels, a.mode_names, a.rel_names) == (
        b.n_entities, b.n_base_rels, b.mode_names, b.rel_names)


def qkey(q):
    f = q.formula
    return (f.structure, f.rels, f.node_modes, q.anchors, q.target,
            q.neg_samples, q.hard_neg_samples)


def grouped_keys(grouped):
    """{structure: [(formula fields, [query keys])]} in iteration order."""
    return {s: [((f.structure, f.rels, f.node_modes),
                 [qkey(q) for q in qs]) for f, qs in by_f.items()]
            for s, by_f in grouped.items()}


# ----------------------------------------------------------------- npz
@pytest.mark.parametrize("name", list(KGS))
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_kg_npz_round_trip_across_packages(name, writer, reader, tmp_path):
    kg = _kg(writer, name)
    path = str(tmp_path / "kg.npz")
    SIDES[writer][0].save_kg_npz(path, kg)
    back = SIDES[reader][0].load_kg_npz(path)
    assert_kgs_equal(back, jload.load_kg_npz(path))
    for f in KG_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(kg, f), f)


def test_kg_npz_keeps_names(tmp_path):
    # names as object arrays (the RDF path's KGs carry them)
    from mpqe_tpu.data import rdf as jrdf
    from mpqe_tpu_torch.data import rdf as trdf

    lines = ["<http://x/a> <http://x/p> <http://x/b> .",
             "<http://x/a> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"
             " <http://x/T> ."]
    for rdf, writer in ((trdf, tload), (jrdf, jload)):
        kg = rdf.kg_from_rdf(rdf.parse_ntriples(lines))
        path = str(tmp_path / "named.npz")
        writer.save_kg_npz(path, kg)
        a, b = jload.load_kg_npz(path), tload.load_kg_npz(path)
        assert_kgs_equal(a, b)
        assert b.mode_names == kg.mode_names and b.rel_names == kg.rel_names


# --------------------------------------------------------- graph pickles
@pytest.mark.parametrize("name", list(KGS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_graph_pickle_round_trip_across_packages(name, writer, tmp_path):
    kg = _kg(writer, name)
    path = str(tmp_path / "graph_data.pkl")
    rel_map = SIDES[writer][0].save_graph_pickle(path, kg)
    with open(path, "rb") as f:
        written = f.read()
    # both writers give the same bytes
    other = "jax" if writer == "port" else "port"
    path2 = str(tmp_path / "graph_data_2.pkl")
    other_map = SIDES[other][0].save_graph_pickle(path2, _kg(other, name))
    with open(path2, "rb") as f:
        assert f.read() == written
    np.testing.assert_array_equal(rel_map, other_map)
    jkg, jmodes, jrels = jload.load_graph_pickle(path)
    tkg, tmodes, trels = tload.load_graph_pickle(path)
    assert_kgs_equal(tkg, jkg)
    assert tmodes == jmodes and trels == jrels
    assert list(trels) == list(jrels)  # the same walk order


@pytest.mark.parametrize("name", list(KGS))
def test_graph_pickle_rel_id_map_matches(name):
    np.testing.assert_array_equal(
        tload.graph_pickle_rel_id_map(_kg("port", name)),
        jload.graph_pickle_rel_id_map(_kg("jax", name)))


def test_graph_pickle_base_ids_follow_the_sorted_walk(tmp_path):
    # a hand-written GQE pickle whose sorted key order puts a reverse key
    # first and holds a same-mode relation: base ids, directions and the
    # inverse id of each reverse triple as the reference assigns them
    relations = {"person": [("paper", "writes"), ("person", "knows")],
                 "paper": [("person", "writes")]}
    adj_lists = {
        ("person", "writes", "paper"): {0: {2, 3}, 1: {3}},
        ("paper", "writes", "person"): {2: {0}, 3: {0, 1}},
        ("person", "knows", "person"): {0: {1}, 1: {0}},
    }
    node_maps = {"person": [0, 1], "paper": [2, 3]}
    path = str(tmp_path / "graph_data.pkl")
    with open(path, "wb") as f:
        pickle.dump((relations, adj_lists, node_maps), f)
    jkg, jmodes, jrels = jload.load_graph_pickle(path)
    tkg, tmodes, trels = tload.load_graph_pickle(path)
    assert_kgs_equal(tkg, jkg)
    assert (tmodes, list(trels.items())) == (jmodes, list(jrels.items()))
    assert trels[("paper", "writes", "person")] == 0  # sorts first
    assert trels[("person", "writes", "paper")] == 1  # its inverse


def test_save_graph_pickle_refuses_colliding_keys(tmp_path):
    kg = tsamp.make_random_kg(n_entities=40, n_modes=2, n_base_rels=2,
                              n_triples=100, seed=0)
    kg = dataclasses.replace(kg, rel_names=("r", "r"),
                             rel_domain=np.zeros(2, np.int32),
                             rel_range=np.ones(2, np.int32))
    for mod in (tload, jload):
        with pytest.raises(ValueError, match="not unique") as e:
            mod.save_graph_pickle(str(tmp_path / "g.pkl"), kg)
        if mod is tload:
            port_msg = str(e.value)
    assert port_msg == str(e.value)


# --------------------------------------------------------- query pickles
STRUCT_SETS = {"chains": ("1-chain", "2-chain", "3-chain"),
               "inters": ("2-inter", "3-inter", "3-inter_chain",
                          "3-chain_inter")}


@pytest.mark.parametrize("structs", list(STRUCT_SETS))
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_query_pickle_round_trip_across_packages(structs, writer, reader,
                                                 tmp_path):
    # graph + queries exported together through the rel-id map, reloaded
    # on the other side: equal grouped formulas and queries
    name = "rel12"
    kg = _kg(writer, name)
    w = SIDES[writer][0]
    rel_map = w.save_graph_pickle(str(tmp_path / "graph_data.pkl"), kg)
    sampler = SIDES[writer][1].QuerySampler(kg, seed=3)
    qs = [q for s in STRUCT_SETS[structs]
          for q in sampler.sample_queries(s, 12, n_neg=4)]
    w.save_queries_pickle(str(tmp_path / "q.pkl"), qs, rel_id_map=rel_map)
    r = SIDES[reader][0]
    kg2, _, _ = r.load_graph_pickle(str(tmp_path / "graph_data.pkl"))
    got = r.load_queries_pickle(str(tmp_path / "q.pkl"), kg2)
    jkg2, _, _ = jload.load_graph_pickle(str(tmp_path / "graph_data.pkl"))
    want = jload.load_queries_pickle(str(tmp_path / "q.pkl"), jkg2)
    assert grouped_keys(got) == grouped_keys(want)
    assert sum(len(v) for by_f in got.values() for v in by_f.values()) == \
        len(qs)


def test_query_tuples_match():
    kg_j, kg_t = _kg("jax", "loader"), _kg("port", "loader")
    qj = jsamp.QuerySampler(kg_j, seed=1).sample_queries("3-inter_chain", 10,
                                                         n_neg=4)
    qt = tsamp.QuerySampler(kg_t, seed=1).sample_queries("3-inter_chain", 10,
                                                         n_neg=4)
    tj = [jload.query_to_tuple(q) for q in qj]
    assert [tload.query_to_tuple(q) for q in qt] == tj
    assert [qkey(tload.tuple_to_query_with_schema(t, kg_t)) for t in tj] == \
        [qkey(jload.tuple_to_query_with_schema(t, kg_j)) for t in tj]


def _bad_node_mode_inputs(kg):
    """(structure, anchors, rels) inputs that break the relation schema:
    an anchor of another mode than its relation's domain, a variable slot
    whose next relation expects another mode, and an intersection whose
    relations disagree on the target's mode."""
    def rel_with(domain=None, rng=None, not_domain=None, not_range=None):
        for r in range(kg.n_rels):
            d, g = kg.rel_id_modes(r)
            if ((domain is None or d == domain)
                    and (rng is None or g == rng)
                    and (not_domain is None or d != not_domain)
                    and (not_range is None or g != not_range)):
                return r
        raise AssertionError("no such relation")

    out = []
    r0 = rel_with()
    d0, g0 = kg.rel_id_modes(r0)
    other = int(np.flatnonzero(kg.entity_mode != d0)[0])
    out.append(("1-chain", (other,), (r0,)))
    r1 = rel_with(not_domain=g0)
    anchor = int(np.flatnonzero(kg.entity_mode == d0)[0])
    out.append(("2-chain", (anchor,), (r0, r1)))
    r2 = rel_with(not_range=g0)
    a2 = int(np.flatnonzero(kg.entity_mode == kg.rel_id_modes(r2)[0])[0])
    out.append(("2-inter", (anchor, a2), (r0, r2)))
    return out


@pytest.mark.parametrize("case", [0, 1, 2])
def test_derive_node_modes_strict_raises_the_same_messages(case):
    kg_j, kg_t = _kg("jax", "rel12"), _kg("port", "rel12")
    structure, anchors, rels = _bad_node_mode_inputs(kg_j)[case]
    with pytest.raises(ValueError) as ej:
        jload.derive_node_modes(kg_j, JSTRUCTURES[structure], anchors, rels,
                                strict=True)
    with pytest.raises(ValueError) as et:
        tload.derive_node_modes(kg_t, TSTRUCTURES[structure], anchors, rels,
                                strict=True)
    assert str(et.value) == str(ej.value)
    # and the lenient derivation gives the same modes
    assert tload.derive_node_modes(
        kg_t, TSTRUCTURES[structure], anchors, rels) == \
        jload.derive_node_modes(kg_j, JSTRUCTURES[structure], anchors, rels)


# ---------------------------------------------------------------- splits
def _corrupted(kg, qs):
    """The queries with their first relation moved by 2 (unseen edges)."""
    out = []
    for q in qs:
        rels = ((q.formula.rels[0] + 2) % kg.n_rels,) + q.formula.rels[1:]
        out.append(dataclasses.replace(
            q, formula=dataclasses.replace(q.formula, rels=rels)))
    return out


@pytest.mark.parametrize("structure", ["1-chain", "2-chain", "2-inter",
                                       "3-chain_inter"])
def test_split_one_new_edge_buckets_match(structure):
    kg_j, kg_t = _kg("jax", "loader"), _kg("port", "loader")
    qj = jsamp.QuerySampler(kg_j, seed=5).sample_queries(structure, 12,
                                                         n_neg=4)
    qt = tsamp.QuerySampler(kg_t, seed=5).sample_queries(structure, 12,
                                                         n_neg=4)
    qj, qt = qj[4:] + _corrupted(kg_j, qj[:4]), qt[4:] + _corrupted(kg_t,
                                                                   qt[:4])
    js, jn = jload.split_one_new_edge(qj, kg_j)
    ts, tn = tload.split_one_new_edge(qt, kg_t)
    assert [qkey(q) for q in ts] == [qkey(q) for q in js]
    assert [qkey(q) for q in tn] == [qkey(q) for q in jn]
    assert len(ts) >= 8


def test_split_files_load_to_the_same_buckets(tmp_path):
    kg_j, kg_t = _kg("jax", "loader"), _kg("port", "loader")
    sampler = jsamp.QuerySampler(kg_j, seed=5)
    qs = sampler.sample_queries("2-chain", 12, n_neg=4)
    qs = qs[4:] + _corrupted(kg_j, qs[:4])
    edges = sampler.all_edge_queries(n_neg=4)[:30]
    three = sampler.sample_queries("3-inter", 6, n_neg=4)
    d = str(tmp_path)
    jload.save_queries_pickle(f"{d}/test_edges.pkl", edges)
    jload.save_queries_pickle(f"{d}/test_queries_2.pkl", qs)
    jload.save_queries_pickle(f"{d}/test_queries_3.pkl", three)
    assert grouped_keys(tload.load_split_queries(d, kg_t, "test")) == \
        grouped_keys(jload.load_split_queries(d, kg_j, "test"))
    assert tload.load_split_queries(d, kg_t, "val") == {}
    for name in ("test_queries_2.pkl", "test_edges.pkl"):
        got = tload.load_test_queries_pickle(f"{d}/{name}", kg_t, kg_t)
        want = jload.load_test_queries_pickle(f"{d}/{name}", kg_j, kg_j)
        assert {b: grouped_keys(g) for b, g in got.items()} == \
            {b: grouped_keys(g) for b, g in want.items()}


# --------------------------------------------------------------- sampler
@pytest.mark.parametrize("variant", ["torus", "warp", "band", "band_seg"])
@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_make_rule_kg_matches(variant, noise):
    kw = dict(n_entities=300, n_modes=3, n_base_rels=6, out_degree=2,
              seed=4, variant=variant, noise=noise, seg_width=5)
    assert_kgs_equal(tsamp.make_rule_kg(**kw), jsamp.make_rule_kg(**kw))


def test_make_rule_kg_unknown_variant_raises_the_same():
    with pytest.raises(ValueError) as ej:
        jsamp.make_rule_kg(n_entities=60, variant="spiral")
    with pytest.raises(ValueError) as et:
        tsamp.make_rule_kg(n_entities=60, variant="spiral")
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", list(KGS))
def test_all_edge_queries_match(name):
    qj = jsamp.QuerySampler(_kg("jax", name), seed=2).all_edge_queries(8)
    qt = tsamp.QuerySampler(_kg("port", name), seed=2).all_edge_queries(8)
    assert [qkey(q) for q in qt] == [qkey(q) for q in qj]


def test_edge_queries_of_held_out_edges_match():
    # held-out edges scored against a smaller graph: the target is
    # excluded from the negatives although it is not among the answers
    full_j, full_t = _kg("jax", "loader"), _kg("port", "loader")
    keep = np.arange(full_j.n_triples) % 5 != 0

    def part(kg):
        return dataclasses.replace(kg, heads=kg.heads[keep],
                                   rels=kg.rels[keep], tails=kg.tails[keep])

    held = ~keep
    args = (full_j.heads[held], 2 * full_j.rels[held], full_j.tails[held])
    for n_neg in (4, 40):
        qj = jsamp.QuerySampler(part(full_j), seed=6).edge_queries(
            *args, n_neg=n_neg)
        qt = tsamp.QuerySampler(part(full_t), seed=6).edge_queries(
            *args, n_neg=n_neg)
        assert [qkey(q) for q in qt] == [qkey(q) for q in qj]
        assert all(q.target not in q.neg_samples for q in qt)


# ------------------------------------------------------ raw-edge stores
STORE_FIELDS = ("anchors", "targets", "neg_pool", "neg_ptr", "hard_pool",
                "hard_ptr", "fallback_pool", "ans_pool", "ans_ptr",
                "ans_idx")


@pytest.mark.parametrize("exclude", [True, False])
@pytest.mark.parametrize("name", list(KGS))
def test_stores_from_edges_match(exclude, name):
    js = jstore.stores_from_edges(_kg("jax", name), exclude_answers=exclude)
    ts = tstore.stores_from_edges(_kg("port", name), exclude_answers=exclude)
    assert list(ts) == list(js) == ["1-chain"]
    assert len(ts["1-chain"]) == len(js["1-chain"])
    for a, b in zip(ts["1-chain"], js["1-chain"]):
        assert dataclasses.astuple(a.formula) == dataclasses.astuple(b.formula)
        for f in STORE_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None, f
                continue
            np.testing.assert_array_equal(x, y, f)
            assert x.dtype == y.dtype, f
    # one fallback pool per range mode, shared across stores
    pools = {id(s.fallback_pool) for s in ts["1-chain"]}
    assert len(pools) == len({s.formula.node_modes[1]
                              for s in ts["1-chain"]})


BATCH_FIELDS = ("node_entity", "node_mode", "edge_rel", "edge_norm",
                "target", "negatives", "neg_mask", "query_mask")


@pytest.mark.parametrize("exclude", [True, False])
def test_raw_edge_batches_match(exclude):
    js = jstore.stores_from_edges(_kg("jax", "loader"),
                                  exclude_answers=exclude)["1-chain"]
    ts = tstore.stores_from_edges(_kg("port", "loader"),
                                  exclude_answers=exclude)["1-chain"]
    rng = np.random.default_rng(0)
    for i in range(0, len(ts), 2):
        pick = rng.integers(0, ts[i].n_queries, size=24).astype(np.int64)
        for B, n_neg in ((32, 4), (64, 16)):
            jb = jstore.pack_dense_batch_np(js[i], pick, B, n_neg, seed=i)
            tb = tstore.pack_dense_batch_np(ts[i], pick, B, n_neg, seed=i)
            for f in BATCH_FIELDS:
                np.testing.assert_array_equal(getattr(tb, f),
                                              getattr(jb, f), f)
        if exclude:  # every drawn negative lies outside its head's answers
            s = ts[i]
            for qi, row, m in zip(pick, tb.negatives, tb.neg_mask):
                g = s.ans_idx[qi]
                ans = set(s.ans_pool[s.ans_ptr[g]:s.ans_ptr[g + 1]].tolist())
                assert not ans & set(row[m > 0].tolist())
