#!/usr/bin/env python3
"""Raw RDF (N-Triples) -> run-ready MPQE dataset directory (counterpart
of ``tools/prepare_dataset.py``; numpy and Python, no torch).

The GQE pipeline's pickle layout (SURVEY.md §2.1 "Data acquisition /
preprocessing", §3.5), produced from raw ``.nt(.gz)`` bytes
(AIFB/MUTAG/AM-style RDF benchmark KGs) or from a ``kg.npz``; the same
input and seed give a directory whose every file loads to the same
contents as the reference tool's:

  graph_data.pkl                 train-split KG (GQE format)
  kg.npz / kg_full.npz           native array KGs (train split / full)
  train_edges.pkl                one 1-chain query per train edge
  val_edges.pkl, test_edges.pkl  1-chain queries for HELD-OUT edges
  {train,val,test}_queries_{2,3}.pkl   multi-hop queries per arity

Protocol (GQE lineage, SURVEY.md §A.3/§A.4):
- a random ``--val_edge_frac`` / ``--test_edge_frac`` of base triples is
  held out of the training graph; their 1-chain queries (negatives drawn
  against the FULL graph's answer sets) are the unseen-edge split,
- multi-hop train queries are sampled on the TRAIN graph,
- multi-hop val/test queries are sampled on the FULL graph and deduped
  against train (and each other); at load time
  ``load_test_queries_pickle`` buckets them into full_neg /
  one_new_edge against the train graph,
- ids are remapped through ``save_graph_pickle``'s rel-id map so the
  pickles stay consistent after a load round trip.

Usage:
  python -m mpqe_tpu_torch.tools.prepare_dataset --nt data.nt.gz \
      --out datadir [--min_rel_count 5] [--val_edge_frac 0.1] \
      [--test_edge_frac 0.1] [--train_per_structure 1000] \
      [--eval_per_structure 100] [--n_neg 32] [--seed 0]
  python -m mpqe_tpu_torch.tools.prepare_dataset --npz kg.npz --out datadir
  python -m mpqe_tpu_torch.train --data pkl:datadir ...
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from mpqe_tpu_torch.data import loader as loader_mod
from mpqe_tpu_torch.data import rdf as rdf_mod
from mpqe_tpu_torch.data.sampler import QuerySampler
from mpqe_tpu_torch.graph import KnowledgeGraph

ARITY = {  # multi-hop pickle shard per reference naming: queries_{2,3}
    "2-chain": 2, "2-inter": 2,
    "3-chain": 3, "3-inter": 3, "3-inter_chain": 3, "3-chain_inter": 3,
}


def log(msg):
    print(msg, flush=True)


def split_kg(kg: KnowledgeGraph, val_frac, test_frac, seed):
    """Hold out random base triples; train KG keeps the FULL entity and
    relation vocabulary (ids shared across splits)."""
    rng = np.random.default_rng(seed)
    n = kg.n_triples
    perm = rng.permutation(n)
    n_val = int(n * val_frac)
    n_test = int(n * test_frac)
    val_idx, test_idx = perm[:n_val], perm[n_val:n_val + n_test]
    train_idx = np.sort(perm[n_val + n_test:])
    train_kg = KnowledgeGraph(
        n_entities=kg.n_entities, n_base_rels=kg.n_base_rels,
        entity_mode=kg.entity_mode,
        rel_domain=kg.rel_domain, rel_range=kg.rel_range,
        heads=kg.heads[train_idx], rels=kg.rels[train_idx],
        tails=kg.tails[train_idx],
        mode_names=kg.mode_names, rel_names=kg.rel_names,
    )
    return train_kg, np.sort(val_idx), np.sort(test_idx)


def heldout_edge_queries(kg_full, sampler_full, idx, n_neg):
    """Held-out base triples -> forward-directed 1-chain queries with
    full-graph negative exclusion."""
    h, r, t = kg_full.heads[idx], kg_full.rels[idx], kg_full.tails[idx]
    return sampler_full.edge_queries(h, 2 * r, t, n_neg=n_neg)


def qkey(q):
    return (q.formula.structure, q.formula.rels, q.anchors, q.target)


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--nt", help="N-Triples file (.nt or .nt.gz)")
    src.add_argument("--npz", help="native kg.npz instead of RDF input")
    ap.add_argument("--out", required=True)
    ap.add_argument("--min_rel_count", type=int, default=1,
                    help="prune base relations with fewer triples")
    ap.add_argument("--val_edge_frac", type=float, default=0.1)
    ap.add_argument("--test_edge_frac", type=float, default=0.1)
    ap.add_argument("--train_per_structure", type=int, default=1000)
    ap.add_argument("--eval_per_structure", type=int, default=100,
                    help="val AND test multi-hop queries per structure")
    ap.add_argument("--n_neg", type=int, default=32)
    ap.add_argument("--n_hard_neg", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t0 = time.time()
    if args.nt:
        log(f"parsing {args.nt} ...")
        kg = rdf_mod.load_ntriples_kg(
            args.nt, min_rel_count=args.min_rel_count)
    else:
        kg = loader_mod.load_kg_npz(args.npz)
    log(f"KG: {kg.n_entities} entities / {kg.n_modes} modes / "
        f"{kg.n_base_rels} base rels / {kg.n_triples} triples "
        f"({time.time()-t0:.1f}s)")

    train_kg, val_idx, test_idx = split_kg(
        kg, args.val_edge_frac, args.test_edge_frac, args.seed)
    log(f"split: train {train_kg.n_triples} / val {val_idx.size} / "
        f"test {test_idx.size} triples")

    os.makedirs(args.out, exist_ok=True)
    rel_id_map = loader_mod.save_graph_pickle(
        os.path.join(args.out, "graph_data.pkl"), train_kg)
    loader_mod.save_kg_npz(os.path.join(args.out, "kg.npz"), train_kg)
    loader_mod.save_kg_npz(os.path.join(args.out, "kg_full.npz"), kg)

    sampler_train = QuerySampler(train_kg, seed=args.seed + 1)
    sampler_full = QuerySampler(kg, seed=args.seed + 2)

    def save(name, queries):
        loader_mod.save_queries_pickle(
            os.path.join(args.out, name), queries, rel_id_map)
        log(f"  {name}: {len(queries)} queries")

    log("edge (1-chain) splits ...")
    save("train_edges.pkl", sampler_train.all_edge_queries(args.n_neg))
    save("val_edges.pkl",
         heldout_edge_queries(kg, sampler_full, val_idx, args.n_neg))
    save("test_edges.pkl",
         heldout_edge_queries(kg, sampler_full, test_idx, args.n_neg))

    log("multi-hop queries ...")
    seen = set()
    shards = {}  # (split, arity) -> list
    for s, arity in ARITY.items():
        tq = sampler_train.sample_queries(
            s, args.train_per_structure, n_neg=args.n_neg,
            n_hard_neg=args.n_hard_neg)
        seen.update(qkey(q) for q in tq)
        shards.setdefault(("train", arity), []).extend(tq)
        for split in ("val", "test"):
            got, bucket = 0, []
            tries = 0
            while got < args.eval_per_structure:
                q = sampler_full.sample_query(
                    s, n_neg=2 * args.n_neg, n_hard_neg=args.n_hard_neg)
                tries += 1
                if q is None or (qkey(q) in seen):
                    if tries > 50 * args.eval_per_structure:
                        log(f"  WARNING: only {got} unique {split} "
                            f"{s} queries (KG too small to dedup more)")
                        break
                    continue
                seen.add(qkey(q))
                bucket.append(q)
                got += 1
            shards.setdefault((split, arity), []).extend(bucket)
    for (split, arity), qs in sorted(shards.items()):
        save(f"{split}_queries_{arity}.pkl", qs)

    meta = dict(
        source=args.nt or args.npz, seed=args.seed,
        n_entities=kg.n_entities, n_modes=kg.n_modes,
        n_base_rels=kg.n_base_rels, n_triples=kg.n_triples,
        train_triples=int(train_kg.n_triples),
        val_triples=int(val_idx.size), test_triples=int(test_idx.size),
        min_rel_count=args.min_rel_count,
        mode_names=list(kg.mode_names)[:64],
    )
    with open(os.path.join(args.out, "dataset.json"), "w") as f:
        json.dump(meta, f, indent=2)
    log(f"done in {time.time()-t0:.1f}s -> {args.out} "
        f"(train: python -m mpqe_tpu_torch.train --data pkl:{args.out})")


if __name__ == "__main__":
    main()
