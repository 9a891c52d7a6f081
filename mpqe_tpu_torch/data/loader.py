"""Dataset loading: GQE/MPQE pickle lineage + a native array format
(counterpart of ``mpqe_tpu/data/loader.py``).

Numpy and Python only: the port reads and writes the reference's formats
byte for byte, so a file written by either package loads in the other to
the same arrays and queries.

The GQE preprocessing pipeline (mpqe/data_utils.py ``load_graph`` /
``load_queries_by_formula``; SURVEY.md §A.3) writes:

  graph_data.pkl  -> (relations, adj_lists, node_maps)
      relations:  {mode: [(to_mode, rel_name), ...]}
      adj_lists:  {(from_mode, rel_name, to_mode): {head_id: set(tail_ids)}}
      node_maps:  {mode: [global entity ids]}
  {train,val,test}_queries_{2,3}.pkl -> lists of query tuples
      (formula_tuple, anchors, target, neg_samples, hard_neg_samples)
      with relations listed target-first (GQE convention) — reversed here
      into this framework's anchor-to-target template-edge order.
  {train,val,test}_edges.pkl -> 1-chain queries (one per KG edge).

``save_queries_pickle`` writes the same format, so round-trip tests pin
the behavior.  The native ``.npz`` format (``save_kg_npz``/``load_kg_npz``)
holds flat int32 arrays with no Python-object unpickling cost.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpqe_tpu_torch.graph import KnowledgeGraph, make_knowledge_graph
from mpqe_tpu_torch.queries import STRUCTURES, Formula, Query, group_queries_by_formula


# ----------------------------------------------------------------------
# Native npz format
# ----------------------------------------------------------------------
def save_kg_npz(path: str, kg: KnowledgeGraph) -> None:
    np.savez_compressed(
        path,
        entity_mode=kg.entity_mode,
        rel_domain=kg.rel_domain,
        rel_range=kg.rel_range,
        heads=kg.heads,
        rels=kg.rels,
        tails=kg.tails,
        mode_names=np.asarray(kg.mode_names, dtype=object)
        if kg.mode_names
        else np.asarray([], dtype=object),
        rel_names=np.asarray(kg.rel_names, dtype=object)
        if kg.rel_names
        else np.asarray([], dtype=object),
    )


def load_kg_npz(path: str) -> KnowledgeGraph:
    z = np.load(path, allow_pickle=True)
    triples = np.stack([z["heads"], z["rels"], z["tails"]], axis=1)
    return make_knowledge_graph(
        triples,
        z["entity_mode"],
        n_base_rels=int(z["rel_domain"].shape[0]),
        rel_domain=z["rel_domain"],
        rel_range=z["rel_range"],
        mode_names=tuple(z["mode_names"].tolist()),
        rel_names=tuple(z["rel_names"].tolist()),
    )


# ----------------------------------------------------------------------
# GQE pickle graph format
# ----------------------------------------------------------------------
def load_graph_pickle(path: str) -> Tuple[KnowledgeGraph, Dict, Dict]:
    """Parse a GQE ``graph_data.pkl`` into a KnowledgeGraph.

    Returns (kg, mode_to_id, reltriple_to_id) where ``reltriple_to_id``
    maps the GQE relation triple ``(from_mode, rel_name, to_mode)`` to
    this framework's *base* relation id (directed ids are 2*base and
    2*base+1, see graph.py).
    """
    with open(path, "rb") as f:
        relations, adj_lists, node_maps = pickle.load(f)

    mode_to_id = {m: i for i, m in enumerate(sorted(node_maps))}
    # global entity id space: GQE node ids are already global; build the
    # mode array from node_maps
    n_entities = 1 + max(
        int(max(ids)) for ids in node_maps.values() if len(ids)
    )
    entity_mode = np.zeros(n_entities, dtype=np.int32)
    for m, ids in node_maps.items():
        entity_mode[np.asarray(list(ids), dtype=np.int64)] = mode_to_id[m]

    # base relations: GQE stores both a triple and its reverse as separate
    # adj_lists keys; keep one base id per unordered pair, mapping the
    # reverse triple onto the inverse direction.
    reltriple_to_id: Dict[Tuple, int] = {}
    rel_domain: List[int] = []
    rel_range: List[int] = []
    rel_names: List[str] = []
    heads, rels, tails = [], [], []
    for key in sorted(adj_lists, key=str):
        from_mode, rel_name, to_mode = key
        rev = (to_mode, rel_name, from_mode)
        if key in reltriple_to_id:
            continue
        base = len(rel_names)
        reltriple_to_id[key] = 2 * base  # forward directed id
        if rev != key:
            reltriple_to_id[rev] = 2 * base + 1  # inverse directed id
        rel_domain.append(mode_to_id[from_mode])
        rel_range.append(mode_to_id[to_mode])
        rel_names.append(str(rel_name))
        for h, ts in adj_lists[key].items():
            for t in ts:
                heads.append(int(h))
                rels.append(base)
                tails.append(int(t))

    triples = np.stack(
        [np.asarray(heads), np.asarray(rels), np.asarray(tails)], axis=1
    ).astype(np.int32)
    kg = make_knowledge_graph(
        triples,
        entity_mode,
        n_base_rels=len(rel_names),
        rel_domain=np.asarray(rel_domain, dtype=np.int32),
        rel_range=np.asarray(rel_range, dtype=np.int32),
        mode_names=tuple(sorted(node_maps)),
        rel_names=tuple(rel_names),
    )
    return kg, mode_to_id, reltriple_to_id


# ----------------------------------------------------------------------
# Query (de)serialization — SURVEY.md §A.3 tuple format
# ----------------------------------------------------------------------
def query_to_tuple(q: Query) -> Tuple:
    """(structure, rels_target_first, anchors, target, negs, hard_negs).

    Relations are stored target-first (GQE convention: the first relation
    is the template edge adjacent to the target) as directed ids.
    """
    rels_tf = tuple(reversed(q.formula.rels))
    return (
        q.formula.structure,
        rels_tf,
        tuple(q.anchors),
        int(q.target),
        tuple(q.neg_samples),
        tuple(q.hard_neg_samples),
    )


def derive_node_modes(
    kg: KnowledgeGraph,
    spec,
    anchors: Sequence[int],
    rels: Sequence[int],
    strict: bool = False,
) -> Tuple[int, ...]:
    """Node-slot modes from the relation schema: anchor slots take their
    entity's mode; each template edge assigns its relation's range mode
    to its destination slot (edges are anchor-to-target topological).

    ``strict=True`` additionally enforces schema consistency — every
    edge's domain mode must match its (already determined) source slot,
    and edges meeting at one destination (intersections) must agree on
    its mode — raising ``ValueError`` otherwise.  The single derivation
    point for both the pickle loader and the serving wire boundary."""
    node_modes = [0] * spec.n_nodes
    for a_i, s in enumerate(spec.anchor_slots):
        node_modes[s] = int(kg.entity_mode[anchors[a_i]])
    assigned = set(spec.anchor_slots)
    for j in range(spec.n_edges):
        from_mode, to_mode = kg.rel_id_modes(rels[j])
        s_slot, d_slot = spec.edge_src[j], spec.edge_dst[j]
        if strict:
            if s_slot in assigned and node_modes[s_slot] != from_mode:
                what = ("anchor" if s_slot in spec.anchor_slots
                        else "variable slot")
                raise ValueError(
                    f"{what} {s_slot} has mode {node_modes[s_slot]} but "
                    f"relation {rels[j]} expects domain mode {from_mode}")
            if d_slot in assigned and node_modes[d_slot] != to_mode:
                raise ValueError(
                    f"relations meeting at slot {d_slot} disagree on its "
                    f"mode ({node_modes[d_slot]} vs relation {rels[j]}'s "
                    f"range {to_mode})")
        node_modes[d_slot] = to_mode
        assigned.add(d_slot)
    return tuple(node_modes)


def tuple_to_query_with_schema(t: Tuple, kg: KnowledgeGraph) -> Query:
    """Deserialize a query tuple, recovering variable-slot modes exactly
    from the KG's relation schema (mode = range of the incoming relation;
    guessing free-slot modes from the target's mode would mislabel real
    data, and the schema is available wherever queries are loaded)."""
    structure, rels_tf, anchors, target, negs, hard = t
    spec = STRUCTURES[structure]
    rels = tuple(reversed(tuple(int(r) for r in rels_tf)))
    node_modes = derive_node_modes(kg, spec, anchors, rels)
    formula = Formula(structure, rels, node_modes)
    return Query(
        formula,
        tuple(int(a) for a in anchors),
        int(target),
        tuple(int(n) for n in negs),
        tuple(int(h) for h in hard),
    )


def save_queries_pickle(
    path: str,
    queries: Sequence[Query],
    rel_id_map: Optional[np.ndarray] = None,
) -> None:
    """Pickle queries in the GQE tuple format.

    ``rel_id_map`` (from :func:`save_graph_pickle` /
    :func:`graph_pickle_rel_id_map`) remaps directed relation ids into the
    vocabulary ``load_graph_pickle`` will assign on reload — pass it
    whenever the queries are exported alongside a ``graph_data.pkl`` so
    the pair stays consistent across the round trip.
    """
    tuples = []
    for q in queries:
        t = query_to_tuple(q)
        if rel_id_map is not None:
            t = (t[0], tuple(int(rel_id_map[r]) for r in t[1])) + t[2:]
        tuples.append(t)
    with open(path, "wb") as f:
        pickle.dump(tuples, f)


def load_queries_pickle(
    path: str, kg: KnowledgeGraph
) -> Dict[str, Dict[Formula, List[Query]]]:
    """Load + group queries (reference load_queries_by_formula layout)."""
    with open(path, "rb") as f:
        tuples = pickle.load(f)
    queries = [tuple_to_query_with_schema(t, kg) for t in tuples]
    return group_queries_by_formula(queries)


def split_one_new_edge(
    queries: Sequence[Query], kg_train: KnowledgeGraph
) -> Tuple[List[Query], List[Query]]:
    """Split eval queries into (all-edges-seen, at-least-one-new-edge)
    buckets — the reference's generalization split (SURVEY.md §A.3).

    An edge of a query is the directed KG edge its template edge binds to;
    "new" means absent from the training graph.
    """
    seen: List[Query] = []
    new: List[Query] = []
    for q in queries:
        spec = q.formula.spec
        # bind each template edge: walk entities where known (anchors &
        # target); variable endpoints cannot be checked -> check only
        # edges with both endpoints bound
        ent = {s: q.anchors[i] for i, s in enumerate(spec.anchor_slots)}
        ent[spec.target_slot] = q.target
        has_new = False
        for j in range(spec.n_edges):
            s_slot, d_slot = spec.edge_src[j], spec.edge_dst[j]
            if s_slot in ent and d_slot in ent:
                nbrs = kg_train.neighbors(q.formula.rels[j], ent[s_slot])
                if ent[d_slot] not in nbrs.tolist():
                    has_new = True
                    break
        (new if has_new else seen).append(q)
    return seen, new


def _graph_pickle_names(kg: KnowledgeGraph) -> Tuple[List[str], List[str]]:
    mode_name = (
        list(kg.mode_names)
        if kg.mode_names
        else [f"mode{m}" for m in range(kg.n_modes)]
    )
    rel_name = (
        list(kg.rel_names)
        if kg.rel_names
        else [f"rel{r}" for r in range(kg.n_base_rels)]
    )
    return mode_name, rel_name


def graph_pickle_rel_id_map(kg: KnowledgeGraph) -> np.ndarray:
    """Directed-rel-id remapping induced by a save/load round trip.

    ``load_graph_pickle`` assigns base ids by lexicographic key order and
    treats whichever of ``(from, name, to)`` / ``(to, name, from)`` sorts
    first as the forward direction — both can differ from this KG's own
    vocabulary.  Returns ``map [2 * n_base_rels]`` with
    ``map[old_directed_id] == new_directed_id`` such that queries remapped
    through it bind the same edges after
    ``load_graph_pickle(save_graph_pickle(kg))``.
    """
    mode_name, rel_name = _graph_pickle_names(kg)
    fwd_key_to_base: Dict[Tuple, int] = {}
    keys = []
    for r in range(kg.n_base_rels):
        d, rg = mode_name[kg.rel_domain[r]], mode_name[kg.rel_range[r]]
        fwd_key_to_base[(d, rel_name[r], rg)] = r
        keys.append((d, rel_name[r], rg))
        keys.append((rg, rel_name[r], d))
    # replicate the loader's walk: sorted keys, first-seen pair wins
    seen = set()
    id_map = np.zeros(2 * kg.n_base_rels, dtype=np.int32)
    new_base = 0
    for key in sorted(set(keys), key=str):
        from_mode, name, to_mode = key
        rev = (to_mode, name, from_mode)
        if key in seen:
            continue
        seen.add(key)
        seen.add(rev)
        if key in fwd_key_to_base:
            # loader treats `key` as forward; original forward matches
            r = fwd_key_to_base[key]
            id_map[2 * r] = 2 * new_base
            id_map[2 * r + 1] = 2 * new_base + 1
        else:
            # loader's forward is this KG's inverse direction
            r = fwd_key_to_base[rev]
            id_map[2 * r] = 2 * new_base + 1
            id_map[2 * r + 1] = 2 * new_base
        new_base += 1
    return id_map


def save_graph_pickle(path: str, kg: KnowledgeGraph) -> np.ndarray:
    """Write a KnowledgeGraph as a GQE-format ``graph_data.pkl``
    (inverse of load_graph_pickle; useful for round-trip tests and for
    exporting synthetic KGs to reference-compatible form).

    Returns the directed-rel-id map (:func:`graph_pickle_rel_id_map`)
    that makes query pickles consistent with the reloaded graph — pass it
    to :func:`save_queries_pickle` when exporting a graph+queries pair.
    """
    mode_name, rel_name = _graph_pickle_names(kg)
    relations: Dict = {m: [] for m in mode_name}
    adj_lists: Dict = {}
    for r in range(kg.n_base_rels):
        d, rg = mode_name[kg.rel_domain[r]], mode_name[kg.rel_range[r]]
        key, rev = (d, rel_name[r], rg), (rg, rel_name[r], d)
        if key in adj_lists or rev in adj_lists:
            raise ValueError(
                f"relation key {key} is not unique across the vocabulary; "
                "the GQE pickle format cannot represent it — rename the "
                "relation before exporting"
            )
        relations[d].append((rg, rel_name[r]))
        if rg != d:
            relations[rg].append((d, rel_name[r]))
        adj_lists[key] = {}
        if rev != key:
            adj_lists[rev] = {}
    for h, r, t in zip(kg.heads, kg.rels, kg.tails):
        d, rg = mode_name[kg.rel_domain[r]], mode_name[kg.rel_range[r]]
        adj_lists[(d, rel_name[r], rg)].setdefault(int(h), set()).add(int(t))
        if rg != d:
            # same-mode relations have a single collided key; the loader
            # reconstructs inverse adjacency itself, so writing reverse
            # pairs there would corrupt the forward edge set
            adj_lists[(rg, rel_name[r], d)].setdefault(int(t), set()).add(int(h))
    node_maps = {
        m: [int(e) for e in np.where(kg.entity_mode == mi)[0]]
        for mi, m in enumerate(mode_name)
    }
    with open(path, "wb") as f:
        pickle.dump((relations, adj_lists, node_maps), f)
    return graph_pickle_rel_id_map(kg)


def load_split_queries(d: str, kg, split: str) -> Dict:
    """Merge ``{split}_edges.pkl`` + ``{split}_queries_{2,3}.pkl`` from a
    prepared dataset dir into ``{structure: {Formula: [Query]}}``.
    Missing files are skipped (datasets may ship any subset)."""
    out: Dict = {}
    for name in ([f"{split}_edges.pkl"]
                 + [f"{split}_queries_{a}.pkl" for a in (2, 3)]):
        p = os.path.join(d, name)
        if os.path.exists(p):
            for s, by_f in load_queries_pickle(p, kg).items():
                out.setdefault(s, {}).update(by_f)
    return out


def load_test_queries_pickle(
    path: str, kg: KnowledgeGraph, train_kg: Optional[KnowledgeGraph] = None
) -> Dict[str, Dict[str, Dict[Formula, List[Query]]]]:
    """Reference ``load_test_queries_by_formula`` semantics (SURVEY.md
    §2.1): load eval queries and split them into the ``full_neg`` bucket
    (every query edge present in the training graph) and the
    ``one_new_edge`` generalization bucket (at least one unseen edge).

    ``train_kg`` defaults to ``kg`` (then everything lands in full_neg —
    pass the training-split KG for a real generalization split).
    """
    with open(path, "rb") as f:
        tuples = pickle.load(f)
    queries = [tuple_to_query_with_schema(t, kg) for t in tuples]
    seen, new = split_one_new_edge(queries, train_kg or kg)
    return {
        "full_neg": group_queries_by_formula(seen),
        "one_new_edge": group_queries_by_formula(new),
    }
