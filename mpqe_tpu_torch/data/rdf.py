"""RDF / N-Triples ingestion: raw KG bytes -> :class:`KnowledgeGraph`
(counterpart of ``mpqe_tpu/data/rdf.py``; the same bytes give the same
arrays in both packages).

The reference consumes PREPROCESSED pickles; the conversion of the RDF
benchmark KGs (AIFB / MUTAG / AM) into those pickles lives upstream of
the repo (SURVEY.md §2.1 "Data acquisition / preprocessing", §3.5).
This module closes that gap natively, with zero third-party RDF
dependencies (no rdflib in the image): a streaming N-Triples parser and
a deterministic RDF -> KnowledgeGraph conversion following the GQE
lineage's conventions:

- entity modes come from ``rdf:type`` objects — the lexicographically
  smallest type IRI per entity (deterministic under multi-typing);
  untyped entities fall into the ``__untyped__`` mode,
- triples whose object is a literal carry no graph structure → dropped,
- ``rdf:type`` triples type entities and are not themselves relations,
- a predicate observed with multiple (from_mode, to_mode) pairs splits
  into one base relation per pair — the reference's ``adj_lists`` are
  keyed by ``(from_mode, rel, to_mode)`` (SURVEY.md §A.3), so a single
  RDF predicate legitimately yields several relation ids,
- base relations with fewer than ``min_rel_count`` triples are pruned
  (the RDF benchmark preprocessing prunes infrequent predicates), and
  entities that survive in no kept triple are dropped with them.

``python -m mpqe_tpu_torch.tools.prepare_dataset`` drives this end to
end: ``.nt(.gz)`` -> ``graph_data.pkl`` + ``{train,val,test}_edges.pkl``
+ ``{train,val,test}_queries_{2,3}.pkl`` (+ ``kg.npz``), a run-ready
dataset directory for ``python -m mpqe_tpu_torch.train --data
pkl:<dir>``.  :func:`load_ntriples_kg` parses with the C++ parser
(``cpp/mpqe_host.cpp nt_parse`` through ``data/native.py``) when the
library builds, else with the Python one; both give the same arrays.
"""

from __future__ import annotations

import gzip
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mpqe_tpu_torch.graph import KnowledgeGraph, make_knowledge_graph

RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"
UNTYPED_MODE = "__untyped__"


# ----------------------------------------------------------------------
# N-Triples parsing
# ----------------------------------------------------------------------
class NTriplesError(ValueError):
    pass


def _scan_term(line: str, pos: int) -> Tuple[str, bool, int]:
    """Parse one term starting at ``pos``; returns (term, is_literal,
    next_pos).  Terms: ``<IRI>``, ``_:blank``, or ``"literal"`` with
    backslash escapes and an optional ``@lang`` / ``^^<dtype>`` suffix
    (the suffix is consumed but discarded — literals are dropped by the
    KG conversion anyway)."""
    n = len(line)
    if pos >= n:
        raise NTriplesError("truncated statement")
    c = line[pos]
    if c == "<":
        end = line.find(">", pos + 1)
        if end < 0:
            raise NTriplesError(f"unterminated IRI: {line!r}")
        return line[pos + 1 : end], False, end + 1
    if c == "_":
        end = pos
        while end < n and not line[end].isspace():
            end += 1
        term = line[pos:end]
        # a blank-node label cannot END with '.' (PN_CHARS grammar), so a
        # trailing dot is the statement terminator written without the
        # optional whitespace ("... _:b0.")
        if term.endswith("."):
            term, end = term[:-1], end - 1
        return term, False, end
    if c == '"':
        i = pos + 1
        while i < n:
            if line[i] == "\\":
                i += 2
                continue
            if line[i] == '"':
                break
            i += 1
        if i >= n:
            raise NTriplesError(f"unterminated literal: {line!r}")
        lit = line[pos + 1 : i]
        i += 1
        # optional @lang or ^^<dtype>
        if i < n and line[i] == "@":
            # language tags are [a-zA-Z-0-9] only — '.' never belongs to
            # one, so stop there too ("...\"x\"@en.")
            while i < n and not line[i].isspace() and line[i] != ".":
                i += 1
        elif line.startswith("^^<", i):
            end = line.find(">", i + 3)
            if end < 0:
                raise NTriplesError(f"unterminated datatype IRI: {line!r}")
            i = end + 1
        return lit, True, i
    raise NTriplesError(f"unrecognized term at col {pos}: {line!r}")


def _skip_ws(line: str, pos: int) -> int:
    while pos < len(line) and line[pos].isspace():
        pos += 1
    return pos


def parse_ntriples(
    lines: Iterable[str],
) -> Iterator[Tuple[str, str, str, bool]]:
    """Yield ``(subject, predicate, object, object_is_literal)`` per
    statement.  Comment (``#``) and blank lines are skipped; each
    statement must end with ``.``."""
    for lineno, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        try:
            s, s_lit, pos = _scan_term(line, 0)
            if s_lit:
                raise NTriplesError("literal subject")
            pos = _skip_ws(line, pos)
            p, p_lit, pos = _scan_term(line, pos)
            if p_lit or not line[pos - 1] == ">":
                raise NTriplesError("predicate must be an IRI")
            pos = _skip_ws(line, pos)
            o, o_lit, pos = _scan_term(line, pos)
            pos = _skip_ws(line, pos)
            if pos >= len(line) or line[pos] != ".":
                raise NTriplesError("missing terminating '.'")
        except NTriplesError as e:
            raise NTriplesError(f"line {lineno}: {e}") from None
        yield s, p, o, o_lit


def iter_ntriples_file(path: str) -> Iterator[Tuple[str, str, str, bool]]:
    """Stream-parse an ``.nt`` or ``.nt.gz`` file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        yield from parse_ntriples(f)


# ----------------------------------------------------------------------
# RDF -> KnowledgeGraph (array path; both parsers feed it)
# ----------------------------------------------------------------------
def intern_statements(
    statements: Iterable[Tuple[str, str, str, bool]],
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(s, p, o, is_lit) stream -> id triples + first-seen term table.

    The same interning order the native parser (cpp nt_parse) produces,
    so the two front ends are array-identical on identical bytes."""
    intern: Dict[str, int] = {}
    terms: List[str] = []
    spo: List[int] = []
    lit: List[bool] = []

    def tid(t: str) -> int:
        i = intern.get(t)
        if i is None:
            i = intern[t] = len(terms)
            terms.append(t)
        return i

    for s, p, o, o_lit in statements:
        spo.append(tid(s))
        spo.append(tid(p))
        spo.append(tid(o))
        lit.append(o_lit)
    return (np.asarray(spo, np.int32).reshape(-1, 3),
            np.asarray(lit, bool), terms)


def kg_from_terms(
    spo: np.ndarray,
    o_lit: np.ndarray,
    terms: Sequence[str],
    *,
    type_pred: str = RDF_TYPE,
    min_rel_count: int = 1,
    drop_preds: Sequence[str] = (),
) -> KnowledgeGraph:
    """Interned statements -> KnowledgeGraph (array implementation).

    Deterministic: modes sorted by type IRI, base relations sorted by
    (predicate, from_mode, to_mode) strings, entity ids sorted by
    (mode, IRI) — the same bytes always produce the same id assignment.
    (Triple ORDER within the store is id-sorted, which carries no
    semantics — the CSR re-sorts internally.)

    Heavy work (dedup, counting, filtering) runs in id space with
    numpy; strings are touched only at entity/relation granularity.
    """
    spo = np.asarray(spo, np.int32).reshape(-1, 3)
    o_lit = np.asarray(o_lit, bool)
    terms = list(terms)

    def term_id(t: str) -> int:
        try:
            return terms.index(t)
        except ValueError:
            return -1

    type_id = term_id(type_pred)
    drop_ids = [term_id(p) for p in drop_preds]
    s, p, o = spo[:, 0], spo[:, 1], spo[:, 2]

    # entity mode = lexicographically smallest type IRI (rank space)
    is_type = (p == type_id) & ~o_lit
    utypes = np.unique(o[is_type])
    order = sorted(range(len(utypes)), key=lambda i: terms[utypes[i]])
    rank_of = np.empty(len(utypes), np.int64)
    for r_, i in enumerate(order):
        rank_of[i] = r_
    untyped_rank = len(utypes)
    ent_rank = np.full(len(terms), untyped_rank, np.int64)
    if utypes.size:
        t_rank = rank_of[np.searchsorted(utypes, o[is_type])]
        np.minimum.at(ent_rank, s[is_type], t_rank)
    rank_name = [terms[int(utypes[i])] for i in order] + [UNTYPED_MODE]

    # structural triples: non-literal, non-type, non-dropped; dedup
    keep = ~o_lit & (p != type_id)
    for d in drop_ids:
        keep &= p != d
    st = np.unique(spo[keep], axis=0)
    if st.size == 0:
        raise ValueError("no structural (entity-to-entity) triples found")
    s2, p2, o2 = st[:, 0], st[:, 1], st[:, 2]

    # base relation = (predicate, from_mode, to_mode); prune by count
    key_rows = np.stack(
        [p2.astype(np.int64), ent_rank[s2], ent_rank[o2]], axis=1)
    ukeys, inv, counts = np.unique(
        key_rows, axis=0, return_inverse=True, return_counts=True)
    kept_idx = np.flatnonzero(counts >= min_rel_count)
    if kept_idx.size == 0:
        raise ValueError(
            f"min_rel_count={min_rel_count} prunes every relation")
    kept_sorted = sorted(
        kept_idx.tolist(),
        key=lambda i: (terms[int(ukeys[i, 0])],
                       rank_name[int(ukeys[i, 1])],
                       rank_name[int(ukeys[i, 2])]))
    rel_of_key = np.full(len(ukeys), -1, np.int64)
    for new_id, ki in enumerate(kept_sorted):
        rel_of_key[ki] = new_id
    trip_rel = rel_of_key[inv]
    m = trip_rel >= 0
    s3, o3, r3 = s2[m], o2[m], trip_rel[m]

    # modes/entities over SURVIVING triples only (pruning a relation may
    # remove the last reference to an entity or a whole mode)
    ents = np.unique(np.concatenate([s3, o3]))
    ent_mode_name = [rank_name[int(ent_rank[e])] for e in ents]
    ent_order = sorted(
        range(len(ents)),
        key=lambda i: (ent_mode_name[i], terms[int(ents[i])]))
    mode_names = tuple(sorted(set(ent_mode_name)))
    mode_id = {mn: i for i, mn in enumerate(mode_names)}
    eid = np.full(len(terms), -1, np.int64)
    for new_id, i in enumerate(ent_order):
        eid[ents[i]] = new_id
    entity_mode = np.asarray(
        [mode_id[ent_mode_name[i]] for i in ent_order], np.int32)
    trip_arr = np.stack([eid[s3], r3, eid[o3]], axis=1).astype(np.int32)

    def key_names(ki):
        pk, fm, tm = ukeys[ki]
        return terms[int(pk)], rank_name[int(fm)], rank_name[int(tm)]

    rel_domain = np.asarray(
        [mode_id[key_names(ki)[1]] for ki in kept_sorted], np.int32)
    rel_range = np.asarray(
        [mode_id[key_names(ki)[2]] for ki in kept_sorted], np.int32)
    # embed the mode pair in the name: keeps (from, name, to) pickle keys
    # unique even when one predicate spans several mode pairs
    rel_names = tuple(
        "{}|{}>{}".format(*key_names(ki)) for ki in kept_sorted)
    return make_knowledge_graph(
        trip_arr,
        entity_mode,
        len(kept_sorted),
        rel_domain=rel_domain,
        rel_range=rel_range,
        mode_names=mode_names,
        rel_names=rel_names,
    )


def kg_from_rdf(
    triples: Iterable[Tuple[str, str, str, bool]],
    **kw,
) -> KnowledgeGraph:
    """Parsed RDF statements -> KnowledgeGraph (see kg_from_terms)."""
    spo, lit, terms = intern_statements(triples)
    if spo.size == 0:
        raise ValueError("no structural (entity-to-entity) triples found")
    return kg_from_terms(spo, lit, terms, **kw)


def load_ntriples_kg(path: str, native: Optional[bool] = None,
                     **kw) -> KnowledgeGraph:
    """``.nt(.gz)`` file -> KnowledgeGraph.

    ``native=None`` parses with the C++ parser (``cpp/mpqe_host.cpp
    nt_parse``: term interning at native speed, the IO-heavy half of
    ingestion) when ``data/native.py`` can build and load it, else with
    the Python parser; ``True`` forces the C++ parser (``RuntimeError``
    when it is unavailable), ``False`` the Python one.  Both give the
    same arrays."""
    from mpqe_tpu_torch.data import native as native_mod

    if native is None:
        use_native = native_mod.available()
    elif native:
        if not native_mod.available():
            raise RuntimeError(
                "native N-Triples parser requested but the C++ host "
                "library (cpp/mpqe_host.cpp) is unavailable: "
                f"{native_mod.BUILD_ERROR}")
        use_native = True
    else:
        use_native = False
    if use_native:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = f.read()
        spo, lit, terms = native_mod.parse_ntriples_native(data)
        return kg_from_terms(spo, lit, terms, **kw)
    return kg_from_rdf(iter_ntriples_file(path), **kw)
