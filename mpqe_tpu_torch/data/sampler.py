"""Query sampling over a KG: instantiate query DAGs, answers, negatives.

The PyTorch port's own numpy copy of ``mpqe_tpu/data/sampler.py``: the
same seed draws the same numbers, so both packages sample identical
queries and KGs.  The training-data helpers ``edge_queries`` and
``make_rule_kg`` are not ported yet (ROADMAP Queue 1 item 2).

The reference consumes pre-generated query pickles; the *generation* logic
lives upstream in the GQE codebase (SURVEY.md §3.5).  This module rebuilds
that pipeline from the behavioral spec so synthetic KGs and benchmark
workloads can be produced without any upstream data:

  * sample a query = walk template edges backwards from a random target,
    picking a random incident KG edge at each step (so the query is
    satisfiable by construction);
  * compute the exact answer set by forward traversal (per-node candidate
    sets, intersection over incoming edges);
  * negatives = same-mode non-answers; hard negatives (intersection
    structures) = entities satisfying some-but-not-all conjuncts at the
    target (SURVEY.md §A.4).

Also provides a synthetic KG generator for scale benchmarks
(BASELINE.json config[4]: 100M-edge synthetic KG).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from mpqe_tpu_torch.graph import KnowledgeGraph, make_knowledge_graph
from mpqe_tpu_torch.queries import (
    INTERSECTION_STRUCTURES,
    STRUCTURES,
    Formula,
    Query,
    QueryStructure,
)


class _IncomingIndex:
    """Per-entity CSR over *incoming* directed edges: (rel, src) pairs."""

    def __init__(self, kg: KnowledgeGraph):
        src, rel, dst = kg.directed_edges()
        order = np.argsort(dst, kind="stable")
        self.src = src[order]
        self.rel = rel[order]
        dst_sorted = dst[order]
        self.ptr = np.searchsorted(
            dst_sorted, np.arange(kg.n_entities + 1), side="left"
        )

    def sample_incoming(
        self, entity: int, rng: np.random.Generator
    ) -> Optional[Tuple[int, int]]:
        lo, hi = int(self.ptr[entity]), int(self.ptr[entity + 1])
        if hi <= lo:
            return None
        k = int(rng.integers(lo, hi))
        return int(self.rel[k]), int(self.src[k])


class QuerySampler:
    """Samples satisfiable queries with answers and negatives from a KG."""

    def __init__(self, kg: KnowledgeGraph, seed: int = 0):
        self.kg = kg
        self.rng = np.random.default_rng(seed)
        self.incoming = _IncomingIndex(kg)

    # ------------------------------------------------------------------
    def sample_query(
        self,
        structure: str,
        n_neg: int = 32,
        n_hard_neg: int = 32,
        max_tries: int = 50,
        with_answers: bool = True,
    ) -> Optional[Query]:
        spec = STRUCTURES[structure]
        for _ in range(max_tries):
            inst = self._instantiate(spec)
            if inst is None:
                continue
            entities, rels = inst
            node_modes = tuple(
                int(self.kg.entity_mode[e]) for e in entities
            )
            formula = Formula(structure, tuple(rels), node_modes)
            anchors = tuple(entities[s] for s in spec.anchor_slots)
            target = entities[spec.target_slot]
            if not with_answers:
                return Query(formula, anchors, target)
            answers, per_conjunct = self.evaluate(formula, anchors)
            if target not in answers:
                # by construction this should not happen; skip defensively
                continue
            negs = self._sample_negatives(
                self.kg.entity_mode[target], answers, n_neg
            )
            hard: Tuple[int, ...] = ()
            if structure in INTERSECTION_STRUCTURES and per_conjunct:
                union: Set[int] = set()
                for s in per_conjunct:
                    union |= s
                pool = list(union - answers)
                if pool:
                    k = min(n_hard_neg, len(pool))
                    hard = tuple(
                        int(x)
                        for x in self.rng.choice(
                            np.asarray(pool), size=k, replace=False
                        )
                    )
            return Query(formula, anchors, target, negs, hard)
        return None

    def sample_queries(
        self, structure: str, n: int, n_neg: int = 32, **kw
    ) -> List[Query]:
        out: List[Query] = []
        while len(out) < n:
            q = self.sample_query(structure, n_neg=n_neg, **kw)
            if q is None:
                raise RuntimeError(
                    f"could not sample {structure} queries from this KG"
                )
            out.append(q)
        return out

    # ------------------------------------------------------------------
    def _instantiate(
        self, spec: QueryStructure
    ) -> Optional[Tuple[List[int], List[int]]]:
        """Backward walk: bind target, then each template edge in reverse
        order samples (relation, source entity) incident to its (already
        bound) destination.  Template invariant: edge_src[j] < edge_dst[j]
        and edges are listed anchor-to-target, so reverse order always sees
        a bound destination."""
        rng = self.rng
        entities = [-1] * spec.n_nodes
        rels = [-1] * spec.n_edges
        entities[spec.target_slot] = int(rng.integers(self.kg.n_entities))
        for j in reversed(range(spec.n_edges)):
            dst_slot = spec.edge_dst[j]
            src_slot = spec.edge_src[j]
            dst_e = entities[dst_slot]
            assert dst_e >= 0
            pick = self.incoming.sample_incoming(dst_e, rng)
            if pick is None:
                return None
            rel, src_e = pick
            rels[j] = rel
            if entities[src_slot] >= 0:
                # slot already bound by another edge (cannot happen in the
                # canonical templates, kept for custom structures)
                if entities[src_slot] != src_e:
                    return None
            entities[src_slot] = src_e
        # Intersections with identical (rel, anchor) conjuncts are
        # degenerate — resample those.
        seen = set()
        for j in range(spec.n_edges):
            k = (spec.edge_src[j], rels[j], spec.edge_dst[j])
            if k in seen:
                return None
            seen.add(k)
        return entities, rels

    # ------------------------------------------------------------------
    def _image(self, rel: int, srcs: Set[int]) -> Set[int]:
        img: Set[int] = set()
        for s_e in srcs:
            img.update(int(x) for x in self.kg.neighbors(rel, s_e))
        return img

    def _propagate(
        self,
        formula: Formula,
        anchors: Sequence[int],
        override: Optional[Tuple[int, Set[int]]] = None,
    ) -> Tuple[List[Optional[Set[int]]], Dict[int, List[Set[int]]]]:
        """Forward traversal: per-node candidate sets (intersection over
        incoming edges).  ``override=(node, set)`` replaces that node's
        set (used to evaluate single-conjunct sub-queries).  Also returns
        the per-in-edge conjunct images at every multi-in-edge node."""
        spec = formula.spec
        cand: List[Optional[Set[int]]] = [None] * spec.n_nodes
        for a_i, s in enumerate(spec.anchor_slots):
            cand[s] = {int(anchors[a_i])}
        conjuncts: Dict[int, List[Set[int]]] = {}
        for node in range(spec.n_nodes):
            if override is not None and node == override[0]:
                cand[node] = set(override[1])
                continue
            in_edges = [j for j in range(spec.n_edges) if spec.edge_dst[j] == node]
            if not in_edges:
                continue
            sets: List[Set[int]] = []
            for j in in_edges:
                srcs = cand[spec.edge_src[j]]
                assert srcs is not None, "template not topologically ordered"
                sets.append(self._image(formula.rels[j], srcs))
            cand[node] = set.intersection(*sets) if sets else set()
            if len(sets) > 1:
                conjuncts[node] = sets
        return cand, conjuncts

    def evaluate(
        self, formula: Formula, anchors: Sequence[int]
    ) -> Tuple[Set[int], List[Set[int]]]:
        """Exact answer set by forward traversal.

        Returns (answers, per_conjunct_target_sets): for intersection
        structures, the target answer sets obtained when the intersection
        node keeps only one of its conjuncts — hard negatives are the
        union minus the full intersection (SURVEY.md §A.4: entities
        satisfying a strict subset of the conjuncts).  The intersection
        may sit at a variable (3-chain_inter), so each conjunct image is
        re-propagated to the target.
        """
        spec = formula.spec
        cand, conjuncts = self._propagate(formula, anchors)
        answers = cand[spec.target_slot] or set()
        per_conjunct_target: List[Set[int]] = []
        for node, sets in conjuncts.items():
            if node == spec.target_slot:
                per_conjunct_target.extend(sets)
            else:
                for s in sets:
                    sub_cand, _ = self._propagate(
                        formula, anchors, override=(node, s)
                    )
                    per_conjunct_target.append(
                        sub_cand[spec.target_slot] or set()
                    )
        return answers, per_conjunct_target

    # ------------------------------------------------------------------
    def _sample_negatives(
        self, target_mode: int, answers: Set[int], n_neg: int
    ) -> Tuple[int, ...]:
        pool = self.kg.entities_of_mode(int(target_mode))
        if pool.size == 0:
            return ()
        out: List[int] = []
        tries = 0
        while len(out) < n_neg and tries < 20 * n_neg:
            c = int(pool[int(self.rng.integers(pool.size))])
            tries += 1
            if c not in answers:
                out.append(c)
        return tuple(out)


# ----------------------------------------------------------------------
# Synthetic KG generation (tests + scale benchmarks)
# ----------------------------------------------------------------------
def make_random_kg(
    n_entities: int = 200,
    n_modes: int = 3,
    n_base_rels: int = 5,
    n_triples: int = 2000,
    seed: int = 0,
) -> KnowledgeGraph:
    """A random mode-typed KG whose relations respect a (domain, range)
    schema — enough structure for the sampler/templates to be exercised."""
    rng = np.random.default_rng(seed)
    entity_mode = rng.integers(0, n_modes, size=n_entities).astype(np.int32)
    # ensure every mode has at least one entity
    for m in range(n_modes):
        entity_mode[m % n_entities] = m
    rel_domain = rng.integers(0, n_modes, size=n_base_rels).astype(np.int32)
    rel_range = rng.integers(0, n_modes, size=n_base_rels).astype(np.int32)

    by_mode = [np.where(entity_mode == m)[0] for m in range(n_modes)]
    rels = rng.integers(0, n_base_rels, size=n_triples)
    heads = np.array(
        [by_mode[rel_domain[r]][rng.integers(len(by_mode[rel_domain[r]]))] for r in rels]
    )
    tails = np.array(
        [by_mode[rel_range[r]][rng.integers(len(by_mode[rel_range[r]]))] for r in rels]
    )
    triples = np.stack([heads, rels, tails], axis=1).astype(np.int32)
    triples = np.unique(triples, axis=0)
    return make_knowledge_graph(
        triples,
        entity_mode,
        n_base_rels,
        rel_domain=rel_domain,
        rel_range=rel_range,
    )
