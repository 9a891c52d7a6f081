"""ctypes binding to the repository's C++ host runtime (counterpart of
``mpqe_tpu/data/native.py``).

``cpp/mpqe_host.cpp`` holds the native batch packer, edge-store builder,
synthetic-KG generator, incoming-edge CSR, batched query sampler and
N-Triples parser.  Every entry point has a numpy/Python counterpart
(``store.pack_dense_batch_np``, ``ops/edge_store.build_edge_store``,
``sampler.make_random_kg``, ``rdf.parse_ntriples``), so the port works
without the library; :func:`available` says whether the native path is
active, and the train CLI logs it (``"native_packer"``).

Unlike the reference, which runs ``make -C cpp`` and loads the tracked
``cpp/libmpqe_host.so``, the library is compiled here from
``cpp/mpqe_host.cpp`` with ``g++`` and the flags of ``cpp/Makefile`` into
``mpqe_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
the flags and the host CPU (``-march=native`` code runs only where it was
built), and built to a private name and renamed, so concurrent builds
never load a half-written file.  Nothing under ``cpp/`` is written.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from mpqe_tpu_torch.data.batcher import DenseQueryBatch, template_edge_norm
from mpqe_tpu_torch.data.store import FormulaStore
from mpqe_tpu_torch.ops.edge_store import EdgeStore

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "cpp" / "mpqe_host.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
# cpp/Makefile's CXXFLAGS, then its link step's -shared
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-Wextra", "-shared")

_lib: Optional[ctypes.CDLL] = None
# why the last build or load failed (None: it did not fail)
BUILD_ERROR: Optional[str] = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _cpu_id() -> bytes:
    """The host CPU's model and flags (``/proc/cpuinfo``; the machine
    name elsewhere): ``-march=native`` code is built for them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return platform.machine().encode()


def library_path() -> Path:
    """``_build/libmpqe_host-<hash>.so``: the hash of source, flags and
    host CPU."""
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_cpu_id())
    return BUILD_DIR / f"libmpqe_host-{digest.hexdigest()[:16]}.so"


def ensure_built(quiet: bool = True) -> bool:
    """Compile the library if its file is missing, load it once per
    process; returns availability (a failed build or load gives False and
    its reason in ``BUILD_ERROR``)."""
    global _lib, BUILD_ERROR
    if _lib is not None:
        return True
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = ["g++", *CXXFLAGS, "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}"
                    f"\n{proc.stderr}")
            if not quiet and proc.stderr:
                print(proc.stderr)
            os.replace(tmp, so)
        _lib = _load(str(so))
        BUILD_ERROR = None
        return True
    except Exception as e:  # noqa: BLE001 — the numpy path stands in
        _lib = None
        BUILD_ERROR = f"{type(e).__name__}: {e}"
        return False


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.pack_dense_batch.restype = ctypes.c_int
    lib.pack_dense_batch.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int32,  # anchors, n_q, n_anchor_slots
        _i32p,  # targets
        _i32p, _i64p,  # neg pool/ptr
        _i32p, _i64p, ctypes.c_int32,  # hard pool/ptr, use_hard
        _i32p, ctypes.c_int64,  # fallback pool, size (0 = disabled)
        _i32p, _i64p, _i32p, ctypes.c_int32,  # ans pool/ptr/idx, has_ans
        _i32p, ctypes.c_int32,  # anchor_slot_ids, n_nodes
        _i64p, ctypes.c_int64,  # pick, n_pick
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,  # B, n_neg, seed
        _i32p, _i32p, _i32p, _f32p, _f32p,  # outputs
    ]
    lib.build_edge_store_c.restype = ctypes.c_int
    lib.build_edge_store_c.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        _i32p, _i32p, _i32p, _f32p, _i32p,
    ]
    lib.make_synthetic_kg.restype = ctypes.c_int
    lib.make_synthetic_kg.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_uint64,
        _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
    ]
    lib.build_incoming_csr.restype = ctypes.c_int
    lib.build_incoming_csr.argtypes = [
        ctypes.c_int64, _i32p, _i32p, _i32p, ctypes.c_int64,
        _i64p, _i32p, _i32p,
    ]
    lib.sample_chain_queries.restype = ctypes.c_int
    lib.sample_chain_queries.argtypes = [
        _i64p, _i32p, _i32p,
        ctypes.c_int64, _i32p,
        _i64p, ctypes.c_int32,
        _i32p, _i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
        _i32p, _i32p, _i32p,
    ]
    lib.nt_parse.restype = ctypes.c_uint64
    lib.nt_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.nt_export.restype = ctypes.c_int
    lib.nt_export.argtypes = [
        ctypes.c_uint64, _i32p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        _i64p, ctypes.c_char_p,
    ]
    lib.nt_free.restype = None
    lib.nt_free.argtypes = [ctypes.c_uint64]
    return lib


def available() -> bool:
    return _lib is not None or ensure_built()


def _need_lib() -> ctypes.CDLL:
    if _lib is None:
        raise RuntimeError("call ensure_built() first")
    return _lib


# ----------------------------------------------------------------------
def pack_dense_batch_native(
    store: FormulaStore,
    pick: np.ndarray,
    batch_size: int,
    n_neg: int,
    seed: int,
    use_hard: bool = False,
) -> DenseQueryBatch:
    """The C++ packer, in place of ``store.pack_dense_batch_np``: the
    same fields, pools and masks; its negatives come from another random
    stream than the numpy packer's."""
    lib = _need_lib()
    spec = store.formula.spec
    B = batch_size
    node_entity = np.zeros((B, spec.n_nodes), np.int32)
    node_mode = np.broadcast_to(
        np.asarray(store.formula.node_modes, np.int32)[None, :],
        (B, spec.n_nodes)).copy()
    target = np.zeros((B,), np.int32)
    negatives = np.zeros((B, n_neg), np.int32)
    neg_mask = np.zeros((B, n_neg), np.float32)
    query_mask = np.zeros((B,), np.float32)
    anchor_slots = np.asarray(spec.anchor_slots, np.int32)
    pick64 = np.ascontiguousarray(pick, np.int64)
    # empty hard / fallback / answer pools go in as 1-element dummies
    one = np.zeros(1, np.int32)
    hp = store.hard_pool if store.hard_pool.size else one
    fb = store.fallback_pool
    fb_size = 0 if fb is None else int(fb.size)
    has_ans = store.ans_idx is not None
    rc = lib.pack_dense_batch(
        np.ascontiguousarray(store.anchors), store.n_queries,
        spec.n_anchors,
        np.ascontiguousarray(store.targets),
        np.ascontiguousarray(store.neg_pool) if store.neg_pool.size else one,
        np.ascontiguousarray(store.neg_ptr),
        np.ascontiguousarray(hp),
        np.ascontiguousarray(store.hard_ptr),
        1 if use_hard else 0,
        np.ascontiguousarray(fb) if fb_size else one,
        fb_size,
        np.ascontiguousarray(store.ans_pool)
        if has_ans and store.ans_pool.size else one,
        np.ascontiguousarray(store.ans_ptr) if has_ans
        else np.zeros(2, np.int64),
        np.ascontiguousarray(store.ans_idx) if has_ans else one,
        1 if has_ans else 0,
        anchor_slots, spec.n_nodes,
        pick64, len(pick64),
        B, n_neg, seed,
        node_entity, target, negatives, neg_mask, query_mask,
    )
    if rc != 0:
        raise RuntimeError(f"pack_dense_batch failed rc={rc}")
    return DenseQueryBatch(
        structure=store.formula.structure,
        n_queries=len(pick64),
        node_entity=node_entity,
        node_mode=node_mode,
        edge_rel=np.asarray(store.formula.rels, np.int32),
        edge_norm=template_edge_norm(spec, store.formula.rels),
        target=target,
        negatives=negatives,
        neg_mask=neg_mask,
        query_mask=query_mask,
        used_hard=use_hard,
    )


def build_edge_store_native(
    src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
    n_nodes: int, n_rels: int, capacity: Optional[int] = None,
) -> EdgeStore:
    """The C++ builder, in place of ``ops/edge_store.build_edge_store``."""
    lib = _need_lib()
    n_e = int(len(src))
    cap = capacity if capacity is not None else n_e
    o_src = np.empty(cap, np.int32)
    o_dst = np.empty(cap, np.int32)
    o_rel = np.empty(cap, np.int32)
    o_norm = np.empty(cap, np.float32)
    rel_ptr = np.empty(n_rels + 2, np.int32)
    rc = lib.build_edge_store_c(
        n_e, np.ascontiguousarray(src, np.int32),
        np.ascontiguousarray(dst, np.int32),
        np.ascontiguousarray(rel, np.int32),
        n_nodes, n_rels, cap,
        o_src, o_dst, o_rel, o_norm, rel_ptr,
    )
    if rc != 0:
        raise RuntimeError(f"build_edge_store_c failed rc={rc}")
    return EdgeStore(src=o_src, dst=o_dst, rel=o_rel, norm=o_norm,
                     rel_ptr=rel_ptr, n_edges=n_e, n_nodes=n_nodes,
                     n_rels=n_rels)


def make_synthetic_kg_native(
    n_entities: int, n_modes: int, n_base_rels: int, n_triples: int,
    seed: int = 0,
):
    """A schema-respecting random KG (contiguous mode blocks) from the
    C++ generator; a ``KnowledgeGraph``."""
    from mpqe_tpu_torch.graph import KnowledgeGraph

    lib = _need_lib()
    entity_mode = np.empty(n_entities, np.int32)
    rel_domain = np.empty(n_base_rels, np.int32)
    rel_range = np.empty(n_base_rels, np.int32)
    heads = np.empty(n_triples, np.int32)
    rels = np.empty(n_triples, np.int32)
    tails = np.empty(n_triples, np.int32)
    rc = lib.make_synthetic_kg(
        n_entities, n_modes, n_base_rels, n_triples, seed,
        entity_mode, rel_domain, rel_range, heads, rels, tails,
    )
    if rc != 0:
        raise RuntimeError(f"make_synthetic_kg failed rc={rc}")
    return KnowledgeGraph(
        n_entities=n_entities, n_base_rels=n_base_rels,
        entity_mode=entity_mode, rel_domain=rel_domain, rel_range=rel_range,
        heads=heads, rels=rels, tails=tails,
    )


def build_incoming_csr_native(kg) -> Dict[str, np.ndarray]:
    """The incoming-edge CSR of ``kg`` (build it once and pass it to
    :func:`sample_queries_native`: the build is the expensive part)."""
    lib = _need_lib()
    n_ent = kg.n_entities
    n_in = 2 * kg.n_triples
    in_ptr = np.empty(n_ent + 1, np.int64)
    in_rel = np.empty(max(n_in, 1), np.int32)
    in_src = np.empty(max(n_in, 1), np.int32)
    rc = lib.build_incoming_csr(
        kg.n_triples, np.ascontiguousarray(kg.heads),
        np.ascontiguousarray(kg.rels), np.ascontiguousarray(kg.tails),
        n_ent, in_ptr, in_rel, in_src,
    )
    if rc != 0:
        raise RuntimeError(f"build_incoming_csr failed rc={rc}")
    return {"in_ptr": in_ptr, "in_rel": in_rel, "in_src": in_src}


def sample_queries_native(
    kg, structure: str, n_samples: int, n_neg: int, seed: int = 0,
    csr: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Batched backward-walk query sampling (benchmark-scale: negatives
    are uniform same-mode non-target entities, not checked against the
    answer set; ``data.sampler.QuerySampler`` gives protocol-exact data).

    Needs contiguous-mode entity ids (the native generator's layout).
    Returns ``{entities [n, n_nodes], rels [n, n_edges], negatives [n,
    n_neg]}``; a failed row has ``entities[:, 0] == -1``."""
    from mpqe_tpu_torch.queries import STRUCTURES

    lib = _need_lib()
    spec = STRUCTURES[structure]
    mode_start = np.searchsorted(
        kg.entity_mode, np.arange(kg.n_modes + 1)).astype(np.int64)
    if not np.all(np.diff(kg.entity_mode) >= 0):
        raise ValueError("native sampler needs contiguous-mode entity ids")
    if csr is None:
        csr = build_incoming_csr_native(kg)
    entities = np.empty((n_samples, spec.n_nodes), np.int32)
    rels = np.empty((n_samples, spec.n_edges), np.int32)
    negs = np.empty((n_samples, max(n_neg, 1)), np.int32)
    rc = lib.sample_chain_queries(
        csr["in_ptr"], csr["in_rel"], csr["in_src"], kg.n_entities,
        np.ascontiguousarray(kg.entity_mode),
        mode_start, kg.n_modes,
        np.asarray(spec.edge_src, np.int32),
        np.asarray(spec.edge_dst, np.int32),
        spec.n_edges, spec.n_nodes,
        n_samples, n_neg, seed,
        entities, rels, negs,
    )
    if rc != 0:
        raise RuntimeError(f"sample_chain_queries failed rc={rc}")
    return {"entities": entities, "rels": rels, "negatives": negs}


# ----------------------------------------------------------------------
def parse_ntriples_native(data: bytes):
    """The C++ N-Triples parse and term interning: ``(spo [n, 3] int32
    term ids, o_lit [n] bool, terms)``, the arrays of
    ``rdf.intern_statements(rdf.parse_ntriples(...))`` on the same bytes.
    Raises ``rdf.NTriplesError`` with the 1-based line of a grammar
    error."""
    from mpqe_tpu_torch.data.rdf import NTriplesError

    lib = _need_lib()
    n_trip = ctypes.c_int64()
    n_terms = ctypes.c_int64()
    term_bytes = ctypes.c_int64()
    err_line = ctypes.c_int64()
    handle = lib.nt_parse(
        data, len(data),
        ctypes.byref(n_trip), ctypes.byref(n_terms),
        ctypes.byref(term_bytes), ctypes.byref(err_line))
    try:
        if err_line.value:
            raise NTriplesError(
                f"line {err_line.value}: invalid N-Triples statement")
        spo = np.empty((max(n_trip.value, 1), 3), np.int32)
        o_lit = np.empty(max(n_trip.value, 1), np.uint8)
        offs = np.empty(n_terms.value + 1, np.int64)
        buf = ctypes.create_string_buffer(max(term_bytes.value, 1))
        if lib.nt_export(handle, spo, o_lit, offs, buf) != 0:
            raise RuntimeError("nt_export failed")
    finally:
        lib.nt_free(handle)
    raw = buf.raw[: term_bytes.value]
    terms = [raw[offs[i]:offs[i + 1]].decode("utf-8", "replace")
             for i in range(n_terms.value)]
    spo = spo[: n_trip.value]
    # C++ interns raw bytes, the Python parser decoded text: on invalid
    # UTF-8 the replacing decode can merge byte-distinct terms, so
    # re-intern the decoded strings (first-seen order kept) to give the
    # Python parser's id space on any input
    if len(set(terms)) != len(terms):
        remap: Dict[str, int] = {}
        dedup: list = []
        new_id = np.empty(len(terms), np.int32)
        for i, t in enumerate(terms):
            j = remap.get(t)
            if j is None:
                j = remap[t] = len(dedup)
                dedup.append(t)
            new_id[i] = j
        spo = new_id[spo]
        terms = dedup
    return spo, o_lit[: n_trip.value].astype(bool), terms
