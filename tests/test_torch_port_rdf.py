"""The port's RDF ingestion (``mpqe_tpu_torch/data/rdf.py``) against
``mpqe_tpu/data/rdf.py`` on the same bytes, on the CPU: the N-Triples
terms, the same ``NTriplesError`` on the same bad lines, CR terminators,
invalid UTF-8, a seeded fuzz round trip, the RDF -> KG conversion with
``min_rel_count`` pruning, ``.nt`` and ``.nt.gz`` files, and
``native=True`` refused.

Numpy and Python on both sides: every comparison is exact.  The cases are
the Python-parser cases of ``tests/test_rdf.py``.
"""

import gzip

import numpy as np
import pytest

from mpqe_tpu.data import rdf as jrdf
from mpqe_tpu_torch.data import rdf as trdf

KG_FIELDS = ("entity_mode", "rel_domain", "rel_range", "heads", "rels",
             "tails")

NT = """\
# a comment line

<http://x/alice> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> <http://x/Person> .
<http://x/bob> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> <http://x/Person> .
<http://x/bob> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> <http://x/Author> .
<http://x/p1> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> <http://x/Paper> .
<http://x/alice> <http://x/knows> <http://x/bob> .
<http://x/bob> <http://x/wrote> <http://x/p1> .
<http://x/alice> <http://x/name> "Alice \\"A\\"@home"@en .
<http://x/p1> <http://x/year> "2020"^^<http://www.w3.org/2001/XMLSchema#int> .
_:b0 <http://x/knows> <http://x/alice> .
"""


def assert_kgs_equal(a, b):
    for f in KG_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert (a.n_entities, a.n_base_rels, a.mode_names, a.rel_names) == (
        b.n_entities, b.n_base_rels, b.mode_names, b.rel_names)


def both_parse(lines):
    want = list(jrdf.parse_ntriples(lines))
    got = list(trdf.parse_ntriples(lines))
    assert got == want
    return got


def test_parse_ntriples_terms_match():
    rows = both_parse(NT.splitlines())
    assert len(rows) == 9
    assert rows[6][3] and rows[6][2] == 'Alice \\"A\\"@home'
    assert rows[8][0] == "_:b0" and rows[8][3] is False


def test_parse_ntriples_dot_without_whitespace_matches():
    rows = both_parse([
        "<http://a> <http://p> _:b0.",
        '<http://a> <http://p> "x"@en.',
        "<http://a> <http://p> <http://b>.",
        '<http://a> <http://p> "1"^^<http://t>.',
    ])
    assert [r[2] for r in rows] == ["_:b0", "x", "http://b", "1"]


@pytest.mark.parametrize("bad", [
    "<http://x/a> <http://x/p> <http://x/b>",       # missing dot
    '<http://x/a> "lit" <http://x/b> .',            # literal predicate
    "<http://x/a <http://x/p> <http://x/b> .",      # unterminated IRI
    '<http://x/a> <http://x/p> "open .',            # unterminated literal
    "<http://x/a> <http://x/p>",                    # truncated (no object)
    "<http://x/a>",                                 # truncated (subj only)
    '"lit" <http://x/p> <http://x/b> .',            # literal subject
    '<http://x/a> <http://x/p> "x"^^<http://t .',   # unterminated datatype
    "<http://x/a> _:p <http://x/b> .",              # blank predicate
    "<http://x/a> <http://x/p> ?b .",               # unknown term
])
def test_parse_ntriples_raises_the_same_errors(bad):
    lines = ["<http://x/ok> <http://x/p> <http://x/ok2> .", bad]
    with pytest.raises(jrdf.NTriplesError) as ej:
        list(jrdf.parse_ntriples(lines))
    with pytest.raises(trdf.NTriplesError) as et:
        list(trdf.parse_ntriples(lines))
    assert str(et.value) == str(ej.value)
    assert str(et.value).startswith("line 2: ")
    assert issubclass(trdf.NTriplesError, ValueError)


@pytest.mark.parametrize("data", [
    # bare CR: two statements
    b"<http://a> <http://p> <http://b> .\r<http://c> <http://p> <http://d> .\r",
    # CRLF
    b"<http://a> <http://p> <http://b> .\r\n<http://c> <http://p> <http://d> .\r\n",
    # invalid UTF-8: \xff and \xfe both decode to U+FFFD (one term)
    b"<http://a\xff> <http://p> <http://a\xfe> .\n",
    # mixed terminators + a comment line
    b"# hdr\r<http://a> <http://p> <http://b> .\n<http://c> <http://p> <http://d> .\r\n",
])
def test_cr_terminators_and_invalid_utf8_intern_the_same(data, tmp_path):
    lines = data.decode("utf-8", "replace").splitlines()
    spo_j, lit_j, terms_j = jrdf.intern_statements(jrdf.parse_ntriples(lines))
    spo_t, lit_t, terms_t = trdf.intern_statements(trdf.parse_ntriples(lines))
    assert terms_t == terms_j
    np.testing.assert_array_equal(spo_t, spo_j)
    np.testing.assert_array_equal(lit_t, lit_j)
    assert spo_t.dtype == spo_j.dtype and lit_t.dtype == lit_j.dtype
    # the file reader decodes the same way (errors="replace")
    path = tmp_path / "raw.nt"
    path.write_bytes(data)
    assert list(trdf.iter_ntriples_file(str(path))) == \
        list(jrdf.iter_ntriples_file(str(path)))


def _fuzz_lines(seed, n=300):
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ09_-./#:~%")

    def iri():
        return "http://" + "".join(rng.choice(alphabet,
                                              int(rng.integers(1, 12))))

    def bnode():
        return "_:b" + "".join(rng.choice(list("abc012"), 3))

    def literal():
        body = "".join(rng.choice(alphabet + ['\\"', "\\\\", " "],
                                  int(rng.integers(0, 8))))
        return f'"{body}"' + rng.choice(["", "@en", "@de-DE",
                                         "^^<http://t/int>"])

    lines = []
    for _ in range(n):
        s = bnode() if rng.random() < 0.2 else f"<{iri()}>"
        if rng.random() < 0.4:
            o = literal()
        elif rng.random() < 0.5:
            o = f"<{iri()}>"
        else:
            o = bnode()
        ws1 = " " * int(rng.integers(1, 3))
        ws2 = "\t" if rng.random() < 0.2 else " "
        lines.append(f"{s}{ws1}<{iri()}>{ws2}{o}"
                     f"{rng.choice([' .', '.', '  .  '])}")
    return lines


@pytest.mark.parametrize("seed", [99, 7])
def test_fuzz_round_trip_matches(seed):
    lines = _fuzz_lines(seed)
    got = trdf.intern_statements(trdf.parse_ntriples(lines))
    want = jrdf.intern_statements(jrdf.parse_ntriples(lines))
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[1]) == len(lines)


def test_kg_from_rdf_matches():
    kg = trdf.kg_from_rdf(trdf.parse_ntriples(NT.splitlines()))
    assert_kgs_equal(kg, jrdf.kg_from_rdf(jrdf.parse_ntriples(
        NT.splitlines())))
    assert kg.n_entities == 4 and kg.n_base_rels == 3
    assert trdf.UNTYPED_MODE == jrdf.UNTYPED_MODE in kg.mode_names


@pytest.mark.parametrize("min_rel_count", [1, 2, 3])
def test_min_rel_count_pruning_matches(min_rel_count):
    lines = NT.splitlines() + [
        "<http://x/alice> <http://x/knows> <http://x/bob> .",  # duplicate
        "<http://x/carol> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"
        " <http://x/Person> .",
        "<http://x/carol> <http://x/knows> <http://x/bob> .",
    ]
    if min_rel_count == 3:  # every relation pruned: the same error
        with pytest.raises(ValueError) as ej:
            jrdf.kg_from_rdf(jrdf.parse_ntriples(lines), min_rel_count=3)
        with pytest.raises(ValueError) as et:
            trdf.kg_from_rdf(trdf.parse_ntriples(lines), min_rel_count=3)
        assert str(et.value) == str(ej.value)
        return
    kg = trdf.kg_from_rdf(trdf.parse_ntriples(lines),
                          min_rel_count=min_rel_count)
    assert_kgs_equal(kg, jrdf.kg_from_rdf(jrdf.parse_ntriples(lines),
                                          min_rel_count=min_rel_count))
    if min_rel_count == 2:
        assert kg.n_base_rels == 1 and kg.n_triples == 2
        assert "http://x/Paper" not in kg.mode_names


def test_drop_preds_and_type_pred_match():
    kw = dict(drop_preds=("http://x/wrote",),
              type_pred="http://www.w3.org/1999/02/22-rdf-syntax-ns#type")
    kg = trdf.kg_from_rdf(trdf.parse_ntriples(NT.splitlines()), **kw)
    assert_kgs_equal(kg, jrdf.kg_from_rdf(jrdf.parse_ntriples(
        NT.splitlines()), **kw))
    # no structural triple at all: the same error
    lines = ['<http://a> <http://p> "x" .']
    with pytest.raises(ValueError) as ej:
        jrdf.kg_from_rdf(jrdf.parse_ntriples(lines))
    with pytest.raises(ValueError) as et:
        trdf.kg_from_rdf(trdf.parse_ntriples(lines))
    assert str(et.value) == str(ej.value)


def _synthetic_nt(seed):
    """A random typed graph as N-Triples (entities carry ids, modes via
    rdf:type, some literals)."""
    from mpqe_tpu_torch.data.sampler import make_random_kg

    kg = make_random_kg(n_entities=100, n_modes=3, n_base_rels=4,
                        n_triples=700, seed=seed)
    lines = [f"<http://s/e{e:04d}> <{trdf.RDF_TYPE}> "
             f"<http://s/M{int(m)}> ." for e, m in enumerate(kg.entity_mode)]
    lines += [f"<http://s/e{int(h):04d}> <http://s/r{int(r)}> "
              f"<http://s/e{int(t):04d}> ."
              for h, r, t in zip(kg.heads, kg.rels, kg.tails)]
    lines += [f'<http://s/e{e:04d}> <http://s/label> "e{e}"@en .'
              for e in range(0, 100, 9)]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("gz", [False, True])
def test_load_ntriples_kg_files_match(gz, tmp_path):
    text = _synthetic_nt(7)
    path = str(tmp_path / ("kg.nt.gz" if gz else "kg.nt"))
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    want = jrdf.kg_from_rdf(jrdf.iter_ntriples_file(path), min_rel_count=2)
    for native in (None, False):
        got = trdf.load_ntriples_kg(path, native=native, min_rel_count=2)
        assert_kgs_equal(got, want)
    assert want.n_entities == 100


def test_native_parser_is_refused_naming_its_item(tmp_path, monkeypatch):
    # the C++ parser is ported (tests/test_torch_port_native.py); forced
    # where the library cannot be built it is refused, naming its source
    from mpqe_tpu_torch.data import native

    path = tmp_path / "kg.nt"
    path.write_text("<http://a> <http://p> <http://b> .\n")
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="cpp/mpqe_host.cpp"):
        trdf.load_ntriples_kg(str(path), native=True)
