"""Query-answering server on the card: model -> top-k entity answers.

Counterpart of ``mpqe_tpu/serve.py`` (``QueryServer``) and of the
sampled-stream mode of the root ``serve.py`` CLI:

  * entity embeddings are L2-normalized ONCE at load and stored in the
    candidate table's dtype (``table_dtype``: float32, bfloat16 or int8;
    ``parallel/rank_shard.py``), so cosine scoring is one ``[B, d] @ [d,
    n_entities]`` product per dispatch with f32 scores;
  * queries are grouped per structure and encoded in one call each by the
    per-query-relation encoder: K3, the hand-written CUDA kernel, for
    eligible MPQE models (its operands are built once, here);
  * the GQE baselines rank by the cosine product against the normalized
    table, by the box distance against the raw float32 table (box,
    bibox), or by both (bibox); SoftAnd by the minimum over its branches'
    score matrices;
  * batches are padded to power-of-two buckets (padded rows: entity 0,
    mode 0, relation 0, norm 1), as the reference pads them;
  * candidates are mode-masked and ranked on the card by :func:`top_k`,
    which returns ``lax.top_k``'s ids in ``lax.top_k``'s order.

MPQE and GQE models, their leaves float32 or bfloat16 (``cfg.dtype``);
serving runs on the card by default and raises when there is none
(``device="cpu"`` runs it on the CPU).

CLI (exactly one of ``--run_dir``, ``--state_dict``, ``--init_seed``)::

  python -m mpqe_tpu_torch.serve --run_dir runs/xyz [--ckpt CKPT]
  python -m mpqe_tpu_torch.serve --init_seed 0 --syn_entities 1000000 \\
      --syn_modes 4 --syn_rels 133 --syn_triples 1000000 --batch 256
  python -m mpqe_tpu_torch.serve --model_config run/model_config.json \\
      --state_dict model.pt --syn_entities ... --seed ...

``--run_dir`` serves a run dir of ``python -m mpqe_tpu_torch.train`` as
the root ``serve.py`` does: the KG rebuilt from its ``config.json``, the
model from ``model_config.json`` and ``ckpt/step_N/state.pt`` (``--ckpt``,
else the latest) and, for a GQE neighborhood model, its neighbor table
from ``gqe_fanout`` and ``seed``; the ``--syn_*`` and ``--seed`` flags are
then not read.  ``--state_dict`` and ``--init_seed`` serve MPQE models
only (a GQE model is served from its run dir, as the root CLI serves
it).  ``--answer QUERIES_PKL --out FILE.npz`` is the root CLI's bulk
offline mode: it answers every query of a GQE-format queries pickle
(relation ids in the served KG's vocabulary), writes ``entity_ids [N,
k]``, ``scores [N, k]``, ``structure [N]`` and ``target [N]`` and prints
one JSON line with its wall time, queries/s and hit@k, instead of the
sampled stream.  ``--table_dtype bfloat16|int8`` serves from the
quantized candidate table, as the root CLI does (int8 needs cosine
scoring; a box model takes float32 only).  ``--http HOST:PORT`` serves
the HTTP JSON API of :mod:`mpqe_tpu_torch.netserve` (``POST /v1/answer``,
``GET /healthz``, ``GET /statz``) with cross-request micro-batching
(``--max_wait_ms``) instead of the sampled stream: it prints one
``{"listening": "HOST:PORT", ...}`` line and serves until interrupted.
``--shards N`` (N > 1) serves through :class:`ShardedQueryServer` over a
``(1, N)`` mesh, the entity table row-sharded: on the card N distinct
cards (fewer exit with the reference's message), under ``--device cpu``
N parts on the CPU; MPQE checkpoints only.

  python -m mpqe_tpu_torch.serve --run_dir runs/xyz \\
      --answer /data/AIFB/test_queries_3.pkl --out answers.npz
  python -m mpqe_tpu_torch.serve --run_dir runs/xyz --http 127.0.0.1:8080
  python -m mpqe_tpu_torch.serve --run_dir runs/xyz --shards 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mpqe_tpu_torch.data.batcher import bucket_size, template_edge_norm
from mpqe_tpu_torch.models import is_mpqe
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.ops import fused_fwd as fused_fwd_ops
from mpqe_tpu_torch.ops.dtypes import parse_dtype
from mpqe_tpu_torch.parallel.rank_shard import (
    check_table_dtype, quantize_rows, quantized_scores)
from mpqe_tpu_torch.queries import STRUCTURES, Formula, Query
from mpqe_tpu_torch.train.evaluation import _effective_max_batch


@dataclasses.dataclass
class Answer:
    """Top-k candidate answers for one query."""

    entity_ids: np.ndarray  # [k] int32
    scores: np.ndarray  # [k] float32


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a missing card raises, never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default (pass device='cpu' to run on the CPU)")
    return dev


def top_k(scores: torch.Tensor, k: int):
    """``lax.top_k(scores, k)`` over the last axis: the k largest per
    row, equal scores (``-inf`` included) ordered by ascending id, and at
    the k-th place the lowest ids among the tied.  Returns
    ``(values, ids)``.

    ``torch.topk`` breaks ties in no fixed order, so this takes k+1
    candidates, repairs the rare rows whose k-th and (k+1)-th values tie
    (one host round trip for those rows only), then sorts the k winners
    by (-score, id)."""
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} candidates")
    kk = min(k + 1, n)
    vals, ids = torch.topk(scores, kk, dim=-1)
    if kk > k:
        tied = (vals[:, k] == vals[:, k - 1]).nonzero().flatten().tolist()
        vals, ids = vals[:, :k].clone(), ids[:, :k].clone()
        for r in tied:
            t = vals[r, k - 1]
            n_gt = int((vals[r] > t).sum())
            ids[r, n_gt:] = (scores[r] == t).nonzero().flatten()[:k - n_gt]
    ids, order = torch.sort(ids, dim=-1)
    vals = vals.gather(-1, order)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, ids.gather(-1, order)


TABLE_CHUNK_ROWS = 1 << 16


def candidate_table(ent: torch.Tensor, scale: bool,
                    table_dtype: str) -> torch.Tensor:
    """``[N, d]`` candidate rows in ``table_dtype``: each row taken to
    f32, L2-normalized when ``scale`` (cosine scoring), then quantized
    (:func:`parallel.rank_shard.quantize_rows`), in chunks of
    ``TABLE_CHUNK_ROWS`` rows, so that no f32 copy of the whole table
    lives beside a quantized one.  An f32 table that is not normalized is
    the model's own."""
    if table_dtype == "float32" and not scale and ent.dtype == torch.float32:
        return ent.detach()
    n, d = ent.shape
    qdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}[table_dtype]
    out = torch.empty((n, d), dtype=qdt, device=ent.device)
    with torch.no_grad():
        for lo in range(0, n, TABLE_CHUNK_ROWS):
            rows = ent[lo:lo + TABLE_CHUNK_ROWS].detach().to(torch.float32)
            if scale:
                rows = mpqe_mod._l2_normalize(rows)
            out[lo:lo + TABLE_CHUNK_ROWS] = quantize_rows(rows, table_dtype)
    return out


class QueryServer:
    """Serves MPQE models (both layer kinds) and the GQE baselines
    (``cfg`` an ``MPQEConfig`` or a ``GQEConfig``) on ``device``.

    The model is moved to ``device``.  ``max_batch`` is capped so the
    ``[B, n_entities]`` score matrix stays near 1 GiB and rounded down to
    a power of two, as in the reference.  ``neighbor_table`` (``{"idx",
    "mask"}``) serves a GQE neighborhood anchor encoder.

    ``table_dtype``: the candidate table of the cosine rank product,
    normalized in f32 and quantized once, here (only the quantized table
    is kept): ``"float32"``, ``"bfloat16"`` (half the bytes) or ``"int8"``
    (a quarter; needs ``cfg.scale_scores``, since the normalized rows
    lie in [-1, 1]).  The score matrix stays f32 whatever the table.
    Raises the reference's ``ValueError`` for an unknown dtype, int8
    without cosine scoring, and a box model with a non-f32 table."""

    def __init__(
        self,
        model,
        cfg,
        entity_mode: np.ndarray,
        max_batch: int = 8192,
        table_dtype: str = "float32",
        device=None,
        neighbor_table: Optional[Dict[str, torch.Tensor]] = None,
    ):
        check_table_dtype(table_dtype)
        if table_dtype == "int8" and not cfg.scale_scores:
            raise ValueError(
                "table_dtype='int8' needs cosine scoring "
                "(cfg.scale_scores): quantization relies on normalized "
                "rows being bounded by [-1, 1]")
        if getattr(cfg, "decoder", None) == "box" and \
                table_dtype != "float32":
            raise ValueError(
                "box-decoder serving scores L1 box distances against the "
                "raw f32 entity table; table_dtype variants apply to the "
                "cosine rank matmul only")
        if not isinstance(model.emb.ent, torch.Tensor):
            raise ValueError("the entity table is row-sharded: serve it "
                             "with ShardedQueryServer")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.table_dtype = table_dtype
        self.entity_mode = np.asarray(entity_mode, dtype=np.int32)
        mpqe_model = is_mpqe(cfg)
        per_row = cfg.n_entities
        if mpqe_model and cfg.num_bases is None:
            per_row = max(per_row, cfg.embed_dim * cfg.embed_dim)
        eff = _effective_max_batch(cfg, max_batch, per_row)
        self.max_batch = 1 << (eff.bit_length() - 1)
        self.model = model.to(self.device)
        self._nbr = (None if neighbor_table is None else
                     {k: v.to(self.device) for k, v in
                      neighbor_table.items()})
        if not mpqe_model and cfg.encoder == "neighborhood" and \
                self._nbr is None:
            raise ValueError(
                "GQEConfig.encoder='neighborhood' checkpoints need "
                "neighbor_table= (build_neighbor_table(kg))")
        # the cosine rank product's normalized table; a box model scores
        # the raw float32 table inside gqe.box_score_all and needs none
        self._ent_norm_t = None
        if mpqe_model or cfg.decoder != "box":
            self._ent_norm_t = candidate_table(
                self.model.emb.ent, cfg.scale_scores, table_dtype).t()
        self._mode_dev = torch.as_tensor(self.entity_mode, device=self.device)
        # K3's operands, built once per model (None: no structure of this
        # model can take the kernel)
        self._k3 = (fused_fwd_ops.prepare_fused_multi(self.model, cfg)
                    if mpqe_model and cfg.readout == "tgt"
                    and cfg.num_bases is not None else None)

    @property
    def table_bytes(self) -> int:
        """Bytes of the candidate table (none for a box model)."""
        t = self._ent_norm_t
        return 0 if t is None else t.numel() * t.element_size()

    # ------------------------------------------------------------------
    def _scores(self, structure: str, ne, nm, er, en) -> torch.Tensor:
        """``[B, n_entities]`` scores of one dispatch."""
        cfg = self.cfg
        if not is_mpqe(cfg):
            from mpqe_tpu_torch.models import gqe as gqe_mod

            return gqe_mod.rank_scores(self.model, cfg, structure, ne, er,
                                       self._nbr, self._ent_norm_t,
                                       self.table_dtype)
        q = mpqe_mod.encode_dense_multi_auto(
            self.model, cfg, structure, ne, nm, er, en,
            operands=self._k3).to(torch.float32)
        if cfg.scale_scores:
            q = mpqe_mod._l2_normalize(q)
        return quantized_scores(q, self._ent_norm_t, self.table_dtype)

    def _rank(self, structure: str, k: int, ne, nm, er, en, tm):
        with torch.inference_mode():
            scores = self._scores(structure, ne, nm, er, en)
            scores.masked_fill_(self._mode_dev[None, :] != tm[:, None],
                                float("-inf"))
            return top_k(scores, k)

    def _pack(self, queries: Sequence[Query]):
        spec = STRUCTURES[queries[0].formula.structure]
        n = len(queries)
        B = min(bucket_size(n), self.max_batch)
        ne = np.zeros((B, spec.n_nodes), np.int32)
        nm = np.zeros((B, spec.n_nodes), np.int32)
        er = np.zeros((B, spec.n_edges), np.int32)
        en = np.ones((B, spec.n_edges), np.float32)
        tm = np.zeros((B,), np.int32)
        for i, q in enumerate(queries):
            for a_i, s in enumerate(spec.anchor_slots):
                ne[i, s] = q.anchors[a_i]
            nm[i] = q.formula.node_modes
            er[i] = q.formula.rels
            en[i] = template_edge_norm(spec, q.formula.rels)
            tm[i] = q.formula.node_modes[spec.target_slot]
        return B, ne, nm, er, en, tm

    def answer(self, queries: Sequence[Query], k: int = 10) -> List[Answer]:
        """Top-k answers per query (mode-masked cosine ranking).  Queries
        may mix structures and formulas freely."""
        out: List[Optional[Answer]] = [None] * len(queries)
        by_structure: Dict[str, List[int]] = {}
        for i, q in enumerate(queries):
            by_structure.setdefault(q.formula.structure, []).append(i)
        for structure, idxs in by_structure.items():
            for lo in range(0, len(idxs), self.max_batch):
                part = idxs[lo: lo + self.max_batch]
                self._answer_group(
                    structure, [queries[i] for i in part], part, k, out)
        return out  # type: ignore[return-value]

    def _answer_group(self, structure, qs, positions, k, out):
        _, *arrays = self._pack(qs)
        dev = [torch.from_numpy(a).to(self.device) for a in arrays]
        top_scores, top_ids = self._rank(structure, k, *dev)
        top_scores = top_scores.cpu().numpy()
        top_ids = top_ids.to(torch.int32).cpu().numpy()
        for j, pos in enumerate(positions):
            out[pos] = Answer(entity_ids=top_ids[j], scores=top_scores[j])

    def warmup(self, structures: Sequence[str], batch: int, k: int = 10):
        """Run every (structure, bucket<=batch, k) once ahead of traffic
        (first kernel build, library handles, allocator pools)."""
        for structure in structures:
            spec = STRUCTURES[structure]
            b = 1
            while b <= bucket_size(batch):
                q = Query(
                    Formula(structure, tuple([0] * spec.n_edges),
                            tuple([0] * spec.n_nodes)),
                    tuple([0] * spec.n_anchors), 0, (), (),
                )
                self.answer([q] * b, k=k)
                b *= 2


class ShardedQueryServer(QueryServer):
    """Serving over an entity table row-sharded on ``mesh``'s model axis,
    for tables that exceed one card.  The request surface is
    :class:`QueryServer`'s (``answer``, ``warmup``), so ``netserve``
    serves it unchanged; the layout differs:

    * the encode side is a copy of the model with its entity table
      row-sharded (``parallel/rank_shard.shard_encode_params``: the
      layout the ``--parallel spmd`` train step leaves the table in) and
      the rest on the mesh's first device, where the queries encode.
      Eligible models encode through K3, each dispatch's anchor rows
      gathered from their owner blocks into a compact table (the same
      bits as the unsharded server's K3, one launch a layer);
    * the ranking is ``parallel/rank_shard.make_sharded_topk_fn``: each
      part scores the batch against its own rows and keeps a local
      top-k, and the parts' candidates merge into the global top-k, so no
      ``[B, n_entities]`` matrix exists on any device.  Where a mode has
      fewer than k entities the tail is ``(-inf, -1)`` (the unsharded
      server returns real ids of ``-inf`` candidates there).

    ``max_batch`` is capped by the per-part score rows.  At float32 the
    ranking reads the encode blocks (normalized per dispatch), with no
    second copy of the table; ``table_dtype`` bfloat16 or int8 keeps one
    quantized table per part (int8 blocks padded to a multiple of 8 rows
    for the card's int8 product).  MPQE models only (``ValueError`` for
    a GQE config)."""

    def __init__(self, model, cfg, entity_mode: np.ndarray, mesh,
                 max_batch: int = 8192, table_dtype: str = "float32"):
        from mpqe_tpu_torch.parallel import mesh as mesh_lib
        from mpqe_tpu_torch.parallel import rank_shard

        if not is_mpqe(cfg):
            raise ValueError(
                "sharded serving supports MPQE checkpoints only")
        check_table_dtype(table_dtype)
        if table_dtype == "int8" and not cfg.scale_scores:
            raise ValueError(
                "table_dtype='int8' needs cosine scoring "
                "(cfg.scale_scores): quantization relies on normalized "
                "rows being bounded by [-1, 1]")
        self.cfg = cfg
        self.mesh = mesh
        self.table_dtype = table_dtype
        self.entity_mode = np.asarray(entity_mode, dtype=np.int32)
        n_shards = mesh.shape[mesh_lib.model_axis(mesh)]
        per_row = max(cfg.n_entities // n_shards, 1)
        if cfg.num_bases is None:
            per_row = max(per_row, cfg.embed_dim * cfg.embed_dim)
        eff = _effective_max_batch(cfg, max_batch, per_row)
        self.max_batch = 1 << (eff.bit_length() - 1)
        self._nbr = None
        self.model = rank_shard.shard_encode_params(model, mesh)
        table = self.model.emb.ent
        self.device = table.device
        if table_dtype == "float32":
            self._tables = list(table.blocks)
            self._modes = rank_shard.shard_modes(mesh, self.entity_mode,
                                                 table.n_padded)
        else:
            if not isinstance(model.emb.ent, torch.Tensor):
                raise ValueError(
                    f"table_dtype={table_dtype!r} builds its ranking blocks "
                    f"from the model's whole table: pass the model "
                    f"unsharded (its table is split here)")
            self._tables, self._modes, _ = rank_shard.shard_table(
                mesh, candidate_table(model.emb.ent, cfg.scale_scores,
                                      table_dtype), self.entity_mode)
        self._topk_fns: Dict[int, object] = {}
        self._k3 = (fused_fwd_ops.prepare_fused_multi(self.model, cfg)
                    if cfg.readout == "tgt" and cfg.num_bases is not None
                    else None)

    @property
    def table_bytes(self) -> int:
        """Bytes of the ranking's blocks, all parts (at float32 the encode
        table's own)."""
        return sum(t.numel() * t.element_size() for t in self._tables)

    def _rank(self, structure: str, k: int, ne, nm, er, en, tm):
        from mpqe_tpu_torch.parallel import rank_shard

        fn = self._topk_fns.get(k)
        if fn is None:
            fn = self._topk_fns[k] = rank_shard.make_sharded_topk_fn(
                self.mesh, self.cfg, k, table_dtype=self.table_dtype)
        with torch.inference_mode():
            q = mpqe_mod.encode_dense_multi_auto(
                self.model, self.cfg, structure, ne, nm, er, en,
                operands=self._k3)
            return fn(self._tables, self._modes, q.to(torch.float32), tm)


# ----------------------------------------------------------------------
# CLI: the sampled-stream mode of the root serve.py
# ----------------------------------------------------------------------
FLAGSHIP = dict(embed_dim=128, n_layers=3, num_bases=16, readout="tgt")


def config_from_json(mc: dict):
    """The model config of a run directory's ``model_config.json``: an
    ``MPQEConfig``, or a ``GQEConfig`` when it has no ``readout``.  A GQE
    config keeps its ``bibox_w`` and ``box_alpha`` (the reference's CLIs
    drop both and serve at the defaults; ROADMAP Queue 3 records the
    difference).  ``dtype`` is read in the port's spelling
    (``"torch.bfloat16"``) and in the JAX package's (``"<class
    'jax.numpy.bfloat16'>"``); float32 when absent."""
    dtype = parse_dtype(mc.get("dtype", "float32"))
    if "readout" not in mc:
        from mpqe_tpu_torch.models import gqe as gqe_mod

        defaults = gqe_mod.GQEConfig(1, 1, 1)
        return gqe_mod.GQEConfig(
            n_entities=mc["n_entities"], n_modes=mc["n_modes"],
            n_rels=mc["n_rels"], embed_dim=mc["embed_dim"],
            decoder=mc["decoder"], intersection=mc["intersection"],
            soft_and=mc["soft_and"], margin=mc.get("margin", 1.0),
            encoder=mc.get("encoder", "direct"),
            aggregator=mc.get("aggregator", "mean"),
            scale_scores=mc.get("scale_scores", True),
            box_alpha=mc.get("box_alpha", defaults.box_alpha),
            bibox_w=mc.get("bibox_w", defaults.bibox_w), dtype=dtype)
    return mpqe_mod.MPQEConfig(
        n_entities=mc["n_entities"], n_modes=mc["n_modes"],
        n_rels=mc["n_rels"], embed_dim=mc["embed_dim"],
        n_layers=mc["n_layers"], num_bases=mc["num_bases"],
        readout=mc["readout"], margin=mc.get("margin", 1.0),
        scale_scores=mc.get("scale_scores", True), dtype=dtype)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Serve sampled queries and report latency.")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--requests", type=int, default=100)
    p.add_argument("--batch", type=int, default=1,
                   help="queries per request")
    p.add_argument("--structures", default="1-chain,2-chain,2-inter")
    p.add_argument("--table_dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="candidate-table dtype for the rank product: "
                        "bfloat16 halves / int8 quarters the table bytes "
                        "(int8 needs cosine scoring)")
    p.add_argument("--answer", default=None, metavar="QUERIES_PKL",
                   help="bulk offline mode: answer every query in a GQE-"
                        "format queries pickle and write top-k ids/scores "
                        "to --out (.npz); skips the latency benchmark")
    p.add_argument("--out", default=None,
                   help=".npz output for --answer (entity_ids [N,k], "
                        "scores [N,k], structure [N], target [N])")
    p.add_argument("--http", default=None, metavar="HOST:PORT",
                   help="serve an HTTP JSON API (POST /v1/answer, GET "
                        "/healthz, GET /statz) with cross-request micro-"
                        "batching instead of the sampled-stream benchmark")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="--http: how long a request waits to coalesce "
                        "with concurrent traffic into one dispatch")
    p.add_argument("--shards", type=int, default=0,
                   help=">1: serve over a model-axis mesh of this many "
                        "parts with the entity table row-sharded "
                        "(ShardedQueryServer; MPQE checkpoints only): "
                        "distinct cards, or under --device cpu parts on "
                        "the CPU")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless told otherwise")
    model = p.add_mutually_exclusive_group(required=True)
    model.add_argument("--run_dir", default=None,
                       help="run dir of python -m mpqe_tpu_torch.train: its "
                            "KG, model config and checkpoint")
    model.add_argument("--state_dict", default=None,
                       help="reference-shaped state dict (.pt), e.g. from "
                            "tools/export_torch_checkpoint.py")
    model.add_argument("--init_seed", type=int, default=None,
                       help="serve a randomly initialized model from this "
                            "seed (full width: d=128, 3 layers, 16 bases, "
                            "unless --model_config says otherwise)")
    p.add_argument("--ckpt", default=None,
                   help="with --run_dir: the checkpoint dir to restore "
                        "(defaults to the latest in run_dir/ckpt)")
    p.add_argument("--model_config", default=None,
                   help="model_config.json of a training run")
    p.add_argument("--seed", type=int, default=0, help="KG seed")
    p.add_argument("--syn_entities", type=int, default=500)
    p.add_argument("--syn_modes", type=int, default=3)
    p.add_argument("--syn_rels", type=int, default=6)
    p.add_argument("--syn_triples", type=int, default=5000)
    args = p.parse_args(argv)
    if args.state_dict is not None and args.model_config is None:
        p.error("--state_dict needs --model_config")
    if args.run_dir is not None and args.model_config is not None:
        p.error("--run_dir reads the run's own model_config.json")
    if args.ckpt is not None and args.run_dir is None:
        p.error("--ckpt needs --run_dir")
    return args


def _from_run_dir(args, device):
    """(cfg, kg, model, checkpoint dir, neighbor table or None) of
    ``--run_dir``."""
    from mpqe_tpu_torch import evaluate as eval_cli

    run_cfg, mc = eval_cli.read_run_dir(args.run_dir)
    cfg = config_from_json(mc)
    ckpt, _, model = eval_cli.restore_model(args.run_dir, cfg, args.ckpt,
                                            device)
    kg, _ = eval_cli.load_run_data(run_cfg, "val")
    _check_matches(cfg, kg)
    nbr = eval_cli.run_neighbor_table(run_cfg, cfg, kg, device)
    return cfg, kg, model, ckpt, nbr


def _check_matches(cfg, kg) -> None:
    if (cfg.n_entities, cfg.n_rels) != (kg.n_entities, kg.n_rels):
        raise SystemExit(
            f"model ({cfg.n_entities} entities, {cfg.n_rels} relations) "
            f"does not match the KG ({kg.n_entities}, {kg.n_rels})")


def _from_flags(args, device):
    """(cfg, kg, model, state dict path or None, None) of ``--state_dict``
    or ``--init_seed`` over the ``--syn_*`` KG (MPQE models only)."""
    from mpqe_tpu_torch.convert import model_from_state_dict
    from mpqe_tpu_torch.data.sampler import make_random_kg

    kg = make_random_kg(
        n_entities=args.syn_entities, n_modes=args.syn_modes,
        n_base_rels=args.syn_rels, n_triples=args.syn_triples,
        seed=args.seed)
    if args.model_config is not None:
        with open(args.model_config) as f:
            cfg = config_from_json(json.load(f))
        if not is_mpqe(cfg):
            raise SystemExit("--state_dict and --init_seed serve MPQE "
                             "models; serve a GQE model from its run dir "
                             "(--run_dir)")
    else:
        cfg = mpqe_mod.MPQEConfig(n_entities=kg.n_entities,
                                  n_modes=kg.n_modes, n_rels=kg.n_rels,
                                  **FLAGSHIP)
    _check_matches(cfg, kg)
    if args.init_seed is not None:
        gen = torch.Generator(device=device).manual_seed(args.init_seed)
        model = mpqe_mod.init_mpqe(gen, cfg, device=device)
    else:
        sd = torch.load(args.state_dict, map_location="cpu",
                        weights_only=True)
        model = model_from_state_dict(sd, cfg, device=device)
    return cfg, kg, model, args.state_dict, None


def answer_pickle(server: QueryServer, kg, path: str, out: str, k: int,
                  batch: int, checkpoint) -> dict:
    """``--answer``: every query of the pickle at ``path`` answered in
    one bulk request after warming each of its structures' buckets up to
    ``max_batch``; the top-k written to ``out`` (.npz).  Returns the
    printed record."""
    from mpqe_tpu_torch.data import loader as loader_mod

    grouped = loader_mod.load_queries_pickle(path, kg)
    flat = [q for by_f in grouped.values() for qs in by_f.values()
            for q in qs]
    if not flat:
        raise SystemExit(f"--answer: no queries in {path}")
    # answer() chunks at max_batch, so no larger bucket is ever dispatched
    server.warmup(sorted(grouped),
                  batch=min(max(batch, len(flat)), server.max_batch), k=k)
    t0 = time.perf_counter()
    answers = server.answer(flat, k=k)
    dt = time.perf_counter() - t0
    np.savez(out,
             entity_ids=np.stack([a.entity_ids for a in answers]),
             scores=np.stack([a.scores for a in answers]),
             structure=np.asarray([q.formula.structure for q in flat]),
             target=np.asarray([q.target for q in flat], np.int32))
    hits = sum(int(q.target in a.entity_ids.tolist())
               for q, a in zip(flat, answers))
    return {"checkpoint": checkpoint, "queries": len(flat), "k": k,
            "out": out, "seconds": dt, "queries_per_s": len(flat) / dt,
            "hit_at_k": hits / len(flat)}


def serve_http(server: QueryServer, kg, address, k: int,
               max_wait_ms: float, structures) -> None:
    """``--http``: the netserve front end on ``address`` until
    interrupted (Ctrl-C), then the batcher stopped and the socket
    closed."""
    from mpqe_tpu_torch.netserve import make_http_server

    httpd = make_http_server(server, kg, *address, default_k=k,
                             max_wait_ms=max_wait_ms)
    print(json.dumps({
        "listening": f"{httpd.server_address[0]}:{httpd.server_address[1]}",
        "endpoints": ["GET /healthz", "GET /statz", "POST /v1/answer"],
        "warmed_structures": list(structures),
        "max_wait_ms": max_wait_ms,
    }), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.batcher.stop()
        httpd.server_close()


def main(argv=None):
    from mpqe_tpu_torch.data.sampler import QuerySampler

    args = parse_args(argv)
    if args.answer and not args.out:
        raise SystemExit("--answer requires --out <file.npz>")
    http = None
    if args.http:
        # a malformed flag fails before the model loads and warms up
        host, _, port_s = args.http.rpartition(":")
        try:
            http = (host or "127.0.0.1", int(port_s))
        except ValueError:
            raise SystemExit(
                f"--http expects HOST:PORT, got {args.http!r}") from None
    device = resolve_device(args.device)
    mesh = None
    if args.shards > 1:
        from mpqe_tpu_torch.parallel import mesh as mesh_lib

        mesh = mesh_lib.cli_mesh((1, args.shards), device,
                                 f"--shards {args.shards}")
    cfg, kg, model, checkpoint, nbr = (
        _from_run_dir if args.run_dir is not None else _from_flags)(args,
                                                                   device)
    if mesh is not None:
        if nbr is not None:
            raise SystemExit(
                "--shards does not support neighborhood-GQE checkpoints")
        server = ShardedQueryServer(model, cfg, kg.entity_mode, mesh,
                                    table_dtype=args.table_dtype)
    else:
        server = QueryServer(model, cfg, kg.entity_mode, device=device,
                             neighbor_table=nbr,
                             table_dtype=args.table_dtype)
    if args.answer:
        print(json.dumps(answer_pickle(server, kg, args.answer, args.out,
                                       args.k, args.batch, checkpoint)),
              flush=True)
        return

    structures = args.structures.split(",")
    server.warmup(structures, batch=args.batch, k=args.k)
    if http is not None:
        serve_http(server, kg, http, args.k, args.max_wait_ms, structures)
        return
    sampler = QuerySampler(kg, seed=123)
    pools = {s: sampler.sample_queries(
        s, max(args.requests // len(structures) + args.batch, args.batch),
        n_neg=1) for s in structures}
    rng = np.random.default_rng(0)
    lat = []
    hits = total = 0
    for _ in range(args.requests):
        s = structures[rng.integers(len(structures))]
        pool = pools[s]
        req = [pool[int(i)] for i in rng.integers(0, len(pool), args.batch)]
        t0 = time.perf_counter()
        answers = server.answer(req, k=args.k)
        lat.append(time.perf_counter() - t0)
        for q, a in zip(req, answers):
            total += 1
            hits += int(q.target in a.entity_ids.tolist())
    lat_ms = np.asarray(lat) * 1e3
    print(json.dumps({
        "checkpoint": checkpoint,
        "init_seed": args.init_seed,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "requests": args.requests,
        "batch": args.batch,
        "k": args.k,
        "table_dtype": args.table_dtype,
        "shards": max(args.shards, 1),
        # the candidate table's bytes (none for a box model; all parts'
        # blocks with --shards) and, on the card, the process's peak
        # allocated device memory
        "table_bytes": server.table_bytes,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "queries_per_s": float(total / lat_ms.sum() * 1e3),
        "hit_at_k": hits / max(total, 1),
    }))


if __name__ == "__main__":
    main()
