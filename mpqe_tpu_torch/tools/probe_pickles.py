#!/usr/bin/env python3
"""Probe GQE/MPQE pickle files against the format the port's loader
expects (counterpart of ``tools/probe_pickles.py``).  Run it first on
real ``graph_data.pkl`` and query pickles (AIFB, MUTAG, AM, Bio): it
prints the observed structure of the file, checks each assumption
``mpqe_tpu_torch/data/loader.py`` makes (``load_graph_pickle``,
``tuple_to_query_with_schema``), and names the point to adjust when one
fails, without stopping on a surprise.  The check lines are the
reference's, word for word.

Host Python only; ``--device`` is accepted as by every tool of the port
(the card unless ``--device cpu``; without a card and without that flag
it raises) and nothing runs on it.  Unpickles the file: probe only
files you trust.

  python -m mpqe_tpu_torch.tools.probe_pickles <dir>/graph_data.pkl
  python -m mpqe_tpu_torch.tools.probe_pickles <dir>/train_queries_2.pkl \\
      --kind queries
"""

from __future__ import annotations

import argparse
import os
import pickle

from mpqe_tpu_torch.tools.probe_common import device_of


def describe(obj, depth=0, max_depth=3, max_items=3):
    pad = "  " * depth
    t = type(obj).__name__
    if depth >= max_depth:
        return f"{pad}{t}(...)"
    if isinstance(obj, dict):
        lines = [f"{pad}dict({len(obj)} keys)"]
        for k in list(obj)[:max_items]:
            lines.append(f"{pad}  key={k!r} ->")
            lines.append(describe(obj[k], depth + 2, max_depth, max_items))
        return "\n".join(lines)
    if isinstance(obj, (list, tuple, set)):
        lines = [f"{pad}{t}(len={len(obj)})"]
        for v in list(obj)[:max_items]:
            lines.append(describe(v, depth + 1, max_depth, max_items))
        return "\n".join(lines)
    return f"{pad}{t}: {repr(obj)[:80]}"


def check(name, ok, detail=""):
    mark = "OK " if ok else "FAIL"
    # the detail names the loader's adjustment point: shown on failure
    print(f"[{mark}] {name}" + (f" — {detail}" if detail and not ok else ""))
    return ok


def probe_graph(path):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    print("== structure ==")
    print(describe(obj))
    print("\n== mpqe_tpu_torch/data/loader.py expectations ==")
    n = len(obj) if hasattr(obj, "__len__") else "?"
    ok = check("top level is a 3-tuple",
               isinstance(obj, tuple) and len(obj) == 3,
               f"got {type(obj).__name__} len={n}"
               " -> adjust load_graph_pickle unpacking")
    if not ok:
        return
    relations, adj_lists, node_maps = obj
    check("relations: {mode: [(to_mode, rel_name), ...]}",
          isinstance(relations, dict) and all(
              isinstance(v, list) and all(
                  isinstance(e, tuple) and len(e) == 2 for e in v[:5])
              for v in relations.values()),
          "-> adjust the relations parse")
    k = next(iter(adj_lists))
    check("adj_lists keyed by (from_mode, rel_name, to_mode) triples",
          isinstance(k, tuple) and len(k) == 3,
          f"first key: {k!r}")
    v = adj_lists[k]
    check("adj_lists values are {head: set/list(tails)}",
          isinstance(v, dict),
          f"value type {type(v).__name__}")
    if isinstance(v, dict) and v:
        hv = next(iter(v.values()))
        check("tail container is set/list of ints",
              isinstance(hv, (set, list, tuple)),
              f"got {type(hv).__name__}")
    check("node_maps: {mode: ids}",
          isinstance(node_maps, dict),
          "-> adjust entity-mode construction")
    if isinstance(node_maps, dict):
        ids = next(iter(node_maps.values()))
        gl = None
        try:
            flat = list(ids)
            gl = all(isinstance(int(x), int) for x in flat[:10])
        except (TypeError, ValueError, OverflowError):
            pass
        check("node ids are global ints", bool(gl),
              "-> if per-mode-local, loader must offset them")
        # global ids are disjoint across modes
        seen = set()
        overlap = False
        for m, mids in node_maps.items():
            s = set(int(x) for x in list(mids)[:100000])
            if seen & s:
                overlap = True
            seen |= s
        check("mode id spaces disjoint (global id space)", not overlap,
              "-> overlapping means per-mode-local ids: remap in loader")
    # does the reverse triple exist as its own key?
    rev = (k[2], k[1], k[0])
    check("reverse triple present as separate key", rev in adj_lists,
          "absent -> loader must synthesize inverses (it already does "
          "via make_knowledge_graph)")


def probe_queries(path):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    print("== structure ==")
    print(describe(obj, max_depth=4))
    print("\n== mpqe_tpu_torch/data/loader.py expectations ==")
    check("top level is a list", isinstance(obj, list),
          f"got {type(obj).__name__}")
    if not (isinstance(obj, list) and obj):
        return
    t = obj[0]
    check("entries are tuples", isinstance(t, tuple),
          f"got {type(t).__name__}")
    if isinstance(t, tuple):
        check("6 fields (structure, rels, anchors, target, negs, hard)",
              len(t) == 6,
              f"got {len(t)} fields: adjust tuple_to_query*; reference "
              "formula may be nested (formula_tuple, anchors, ...) instead")
        if len(t) >= 1:
            print(f"    field 0 (structure?): {t[0]!r}")
        if len(t) >= 2:
            print(f"    field 1 (rels, target-first?): {t[1]!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "probe_pickles")
    ap.add_argument("path")
    ap.add_argument("--kind", choices=["graph", "queries", "auto"],
                    default="auto")
    ap.add_argument("--device", default="cuda",
                    help="accepted as by every tool of the port; the probe "
                         "runs on the host")
    args = ap.parse_args(argv)
    device_of(args.device)
    kind = args.kind
    if kind == "auto":
        kind = "graph" if "graph" in os.path.basename(args.path) else "queries"
    (probe_graph if kind == "graph" else probe_queries)(args.path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
