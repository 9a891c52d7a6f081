"""Query sampling over a KG: instantiate query DAGs, answers, negatives.

The PyTorch port's own numpy copy of ``mpqe_tpu/data/sampler.py``: the
same seed draws the same numbers, so both packages sample identical
queries, edge queries (``edge_queries``, ``all_edge_queries``) and KGs
(``make_random_kg``, the rule-structured ``make_rule_kg``).

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

    def all_edge_queries(self, n_neg: int = 32) -> List[Query]:
        """One 1-chain query per DIRECTED KG edge — the reference's
        ``train_edges.pkl`` protocol (SURVEY.md §A.3): 1-chain training
        covers every edge, so multi-hop held-out queries test the
        composition of seen edges rather than unseen-edge prediction."""
        src, rel, dst = self.kg.directed_edges()
        return self.edge_queries(src, rel, dst, n_neg=n_neg)

    def edge_queries(
        self,
        src: Sequence[int],
        rel: Sequence[int],
        dst: Sequence[int],
        n_neg: int = 32,
    ) -> List[Query]:
        """1-chain queries for EXPLICIT directed edges.

        Negatives exclude the full ``(head, rel)`` answer set of THIS
        sampler's KG — pass the full graph's sampler when building
        ``{val,test}_edges.pkl`` for held-out edges so true answers never
        appear as negatives (reference protocol, SURVEY.md §A.4)."""
        out: List[Query] = []
        answers_cache: dict = {}
        for h, r, t in zip(src, rel, dst):
            h, r, t = int(h), int(r), int(t)
            if (r, h) not in answers_cache:
                answers_cache[(r, h)] = set(
                    int(x) for x in self.kg.neighbors(r, h))
            t_mode = int(self.kg.rel_id_modes(r)[1])
            formula = Formula(
                "1-chain", (r,), (int(self.kg.entity_mode[h]), t_mode))
            answers = answers_cache[(r, h)]
            if t not in answers:  # held-out edge: exclude t too, without
                answers = answers | {t}  # copying per own-KG edge (hubs!)
            negs = self._sample_negatives(t_mode, answers, n_neg)
            out.append(Query(formula, (h,), t, negs, ()))
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


def make_rule_kg(
    n_entities: int = 600,
    n_modes: int = 3,
    n_base_rels: int = 6,
    out_degree: int = 2,
    seed: int = 0,
    variant: str = "torus",
    noise: float = 0.0,
    seg_width: int = 8,
) -> KnowledgeGraph:
    """A rule-structured KG with LEARNABLE deterministic relations.

    Entities of each mode sit on a g x g torus grid (a shared latent
    geometry); relation r maps grid point p in its domain mode to
    ``p + delta_{r,k}`` (mod g) in its range mode, for ``out_degree``
    fixed shift vectors delta.  The edge set is thus generated by a few
    global rules: embeddings can discover the latent coordinates from the
    (fully observed) 1-chain edges, after which unseen multi-hop
    COMPOSITIONS follow from the geometry — held-out compositional AUC
    has a ~1.0 ceiling.  (A random-permutation relation would be
    incompressible: no model could generalize to held-out compositions.)

    This is the quality-benchmark substrate for the MPQE-vs-GQE
    comparison (reference protocol SURVEY.md §A.4).  Unlike :func:`make_random_kg`, whose
    (anchor, relation) -> answer mappings are unpredictable noise.

    ``variant`` selects the rule family (the
    torus shifts ARE linear maps, the exact inductive bias of GQE's
    bilinear decoder, so that substrate favors GQE by construction):

    * ``"torus"`` — p -> p + delta (translations; linear maps).
    * ``"warp"``  — piecewise translations: the shift applied at p
      depends on the parity of (i + j), so the relation is a
      deterministic, compositional rule that is NOT a single affine map
      of the latent coordinates.
    * ``"band"``  — many-to-many: even relations map p to the whole
      torus COLUMN i + a_r, odd relations to the whole ROW j + b_r
      (out-degree g).  Single chains are maximally ambiguous (g
      answers); a row x column intersection pins ONE cell — the regime
      where encoder-side intersection expressiveness dominates.
    * ``"band_seg"`` — band's set-valued character at BOUNDED
      out-degree (``seg_width``), so it scales to AM-size entity counts
      without band's g^3 edge blowup (1M entities under full band would
      need ~1e11 edges): even relations map p=(i, j) to the column
      SEGMENT {(i + a_r, j + t) : t < seg_width}, odd relations to the
      row segment {(i + t, j + b_r)}.  Chains stay ambiguous
      (seg_width answers per hop); a column x row segment intersection
      pins ~one cell: the high-ceiling substrate at AM scale.

    ``noise`` rewires that fraction of tails uniformly within the range
    mode (incompressible edges; hurts every model's ceiling, but chained
    compositions amplify it differently per encoder).
    """
    rng = np.random.default_rng(seed)
    per_mode = n_entities // n_modes
    g = int(np.floor(np.sqrt(per_mode)))
    per_mode = g * g  # truncate to a full grid
    n_entities = per_mode * n_modes
    entity_mode = np.repeat(
        np.arange(n_modes), per_mode).astype(np.int32)
    base = np.arange(n_modes) * per_mode  # first entity id of each mode

    rel_domain = np.asarray(
        [r % n_modes for r in range(n_base_rels)], np.int32)
    rel_range = np.asarray(
        [(r + 1 + (r // n_modes)) % n_modes for r in range(n_base_rels)],
        np.int32,
    )
    idx = np.arange(per_mode)
    gi, gj = idx % g, idx // g
    heads, rels, tails = [], [], []

    def emit(r, ti, tj):
        heads.append(base[rel_domain[r]] + idx)
        rels.append(np.full(per_mode, r))
        tails.append(base[rel_range[r]] + ti % g + (tj % g) * g)

    for r in range(n_base_rels):
        if variant == "torus":
            for a, b in rng.integers(0, g, size=(out_degree, 2)):
                emit(r, gi + a, gj + b)
        elif variant == "warp":
            for k in range(out_degree):
                (a0, b0), (a1, b1) = rng.integers(0, g, size=(2, 2))
                odd = (gi + gj) % 2
                emit(r, gi + np.where(odd, a1, a0),
                     gj + np.where(odd, b1, b0))
            # force distinguishable parities: without this, entities
            # within one parity class are related identically and the
            # branch is unlearnable from edges alone — add one plain
            # shift so coordinates stay identifiable
            a, b = rng.integers(0, g, size=2)
            emit(r, gi + a, gj + b)
        elif variant == "band":
            off = int(rng.integers(0, g))
            # orientation alternates every n_modes relations so the two
            # relations sharing a RANGE mode (r and r + n_modes under the
            # range formula above) are crossed — their 2-inter pins a
            # single cell instead of a whole line
            if (r // n_modes) % 2 == 0:  # whole column i + off
                for line in range(g):
                    emit(r, gi + off, np.full(per_mode, line))
            else:  # whole row j + off
                for line in range(g):
                    emit(r, np.full(per_mode, line), gj + off)
        elif variant == "band_seg":
            w = min(seg_width, g)
            off = int(rng.integers(0, g))
            if (r // n_modes) % 2 == 0:  # column segment at i + off
                for t in range(w):
                    emit(r, gi + off, gj + t)
            else:  # row segment at j + off
                for t in range(w):
                    emit(r, gi + t, gj + off)
        else:
            raise ValueError(f"unknown rule-KG variant {variant!r}")
    triples = np.stack(
        [np.concatenate(heads), np.concatenate(rels), np.concatenate(tails)],
        axis=1,
    ).astype(np.int32)
    if noise > 0.0:
        flip = rng.random(triples.shape[0]) < noise
        rr = rel_range[triples[flip, 1]]
        triples[flip, 2] = (base[rr] + rng.integers(
            0, per_mode, size=int(flip.sum()))).astype(np.int32)
    triples = np.unique(triples, axis=0)
    return make_knowledge_graph(
        triples,
        entity_mode,
        n_base_rels,
        rel_domain=rel_domain,
        rel_range=rel_range,
    )
