"""The GQE baselines in PyTorch: metapath composition + set intersection
(counterpart of ``mpqe_tpu/models/gqe.py``).

GQE (Hamilton et al. 2018) composes a relation hop per template edge
(bilinear ``x W_r``, TransE ``x + r``, DistMult ``x * r``, or a
Query2Box-style box hop) and intersects a node's incoming branches (min,
mean or DeepSets).  Query evaluation walks the template's nodes in slot
order (templates guarantee ``edge_src < edge_dst``); the target's
representation scores candidates by cosine, by box affinity, or by both
(``bibox``).  ``SoftAnd`` scores each conjunct branch on its own and takes
the minimum.

``GQE`` is an ``nn.Module`` whose parameter names are the reference's
pytree leaves joined with dots (``emb.ent``, ``rel_mat``, ``box_att1_b``,
``nbr.w_combine``...), so ``convert.gqe_from_numpy`` maps a JAX
checkpoint onto it one to one.  The forward functions are plain functions
with the reference's signatures, the model in place of ``params``.
Candidate rows are gathered with ids clamped, as the reference's gathers
clamp them.  No kernel: the reference computes all of this outside
Pallas, and so does the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from mpqe_tpu_torch.models import aggregators as agg_mod
from mpqe_tpu_torch.models import embeddings as emb_mod
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.ops import dtypes
from mpqe_tpu_torch.ops.rgcn import normal_
from mpqe_tpu_torch.parallel.rank_shard import quantized_scores
from mpqe_tpu_torch.queries import STRUCTURES

DECODERS = ("bilinear", "transe", "distmult", "box", "bibox")
INTERSECTIONS = ("min", "mean", "deepsets")
ENCODERS = ("direct", "neighborhood")
# one [B, chunk, d] float32 temporary of box_score_all stays near this size
BOX_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class GQEConfig:
    n_entities: int
    n_modes: int
    n_rels: int
    embed_dim: int = 128
    decoder: str = "bilinear"
    intersection: str = "deepsets"
    soft_and: bool = False  # SoftAnd conjunct-min scoring
    # anchor encoder: "direct" = embedding lookup; "neighborhood" = the
    # GraphSAGE-style encoder (models/aggregators.py) over a fixed-fanout
    # table passed as ``neighbor_table``
    encoder: str = "direct"
    aggregator: str = "mean"  # mean | max | pool (neighborhood encoder)
    margin: float = 1.0
    scale_scores: bool = True
    # box decoder (Query2Box geometry): weight of the inside-box distance
    box_alpha: float = 0.02
    # bibox: cosine(vec, e) + bibox_w * box_affinity(c, o, e)
    bibox_w: float = 1.0
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.decoder not in DECODERS:
            raise ValueError(f"decoder {self.decoder}")
        if self.intersection not in INTERSECTIONS:
            raise ValueError(f"intersection {self.intersection}")
        if self.encoder not in ENCODERS:
            raise ValueError(f"encoder {self.encoder}")
        if self.aggregator not in agg_mod.AGGREGATORS:
            raise ValueError(f"aggregator {self.aggregator}")
        dtypes.check_model_dtype(self.dtype)


class GQE(nn.Module):
    """GQE parameters in ``cfg.dtype`` (uninitialized; see
    :func:`init_gqe`)."""

    def __init__(self, cfg: GQEConfig, device=None):
        super().__init__()
        d, r = cfg.embed_dim, cfg.n_rels

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.emb = emb_mod.Embeddings(cfg.n_entities, cfg.n_modes, d,
                                      device=device)
        if cfg.encoder == "neighborhood":
            self.nbr = agg_mod.NeighborhoodEncoder(d, cfg.aggregator,
                                                   device=device)
        if cfg.decoder in ("bilinear", "bibox"):
            self.rel_mat = p(r, d, d)
        if cfg.decoder == "transe":
            self.rel_vec = p(r, d)
        if cfg.decoder in ("box", "bibox"):
            self.rel_cen = p(r, d)
            self.rel_off = p(r, d)
            self.box_att1, self.box_att1_b = p(d, d), p(d)
            self.box_att2, self.box_att2_b = p(d, d), p(d)
            self.box_ds1, self.box_ds1_b = p(2 * d, d), p(d)
            self.box_ds2, self.box_ds2_b = p(d, d), p(d)
        if cfg.decoder == "distmult":
            self.rel_diag = p(r, d)
        if cfg.intersection == "deepsets":
            self.int_pre, self.int_pre_b = p(d, d), p(d)
            self.int_post, self.int_post_b = p(d, d), p(d)
        self.to(cfg.dtype)


def _fork(gen: torch.Generator) -> torch.Generator:
    """A generator of its own, seeded from ``gen`` (the reference's
    ``fold_in``: bibox's bilinear noise is drawn apart from its box
    parameters)."""
    seed = int(torch.randint(0, 1 << 62, (1,), generator=gen,
                             device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(seed)


def init_gqe(gen: torch.Generator, cfg: GQEConfig, device=None) -> GQE:
    """A randomly initialized model on ``device``, drawn from ``gen``.
    Same distributions as the reference's ``init_gqe``: bilinear ``I +
    N(0, 0.01/d)``, TransE ``N(0, 1/d)``, DistMult ``1 + N(0, 0.01/d)``,
    box centers ``N(0, 1/d)`` and offsets ``U(0, 0.5/sqrt(d))``, the
    intersection and attention weights ``N(0, 1/d)``, biases 0.  Torch's
    generator gives other bits than JAX's, so parity tests carry JAX
    parameters across instead.  Every leaf is drawn in f32 and rounded
    once to ``cfg.dtype``, as the reference creates it in ``cfg.dtype``."""
    d, r = cfg.embed_dim, cfg.n_rels
    model = GQE(cfg, device="meta")
    model.emb = emb_mod.init_embeddings(gen, cfg.n_entities, cfg.n_modes, d,
                                        device=device)
    if cfg.encoder == "neighborhood":
        model.nbr = agg_mod.init_neighborhood_encoder(gen, d, cfg.aggregator,
                                                      device=device)
    scale = 1.0 / math.sqrt(d)
    s2 = math.sqrt(2.0 / (2 * d))

    def put(name, value):
        setattr(model, name, nn.Parameter(value.to(device)))

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    if cfg.decoder in ("bilinear", "bibox"):
        g = _fork(gen) if cfg.decoder == "bibox" else gen
        eye = torch.eye(d, device=device)
        put("rel_mat", eye[None] + normal_(g, (r, d, d), 0.1 * scale, device))
    if cfg.decoder == "transe":
        put("rel_vec", normal_(gen, (r, d), scale, device))
    if cfg.decoder in ("box", "bibox"):
        put("rel_cen", normal_(gen, (r, d), scale, device))
        u = torch.rand((r, d), generator=gen, device=gen.device)
        put("rel_off", u * (0.5 * scale))
        for name, shape in (("box_att1", (d, d)), ("box_att2", (d, d)),
                            ("box_ds1", (2 * d, d)), ("box_ds2", (d, d))):
            put(name, normal_(gen, shape, s2, device))
            put(name + "_b", zeros(d))
    if cfg.decoder == "distmult":
        put("rel_diag", 1.0 + normal_(gen, (r, d), 0.1 * scale, device))
    if cfg.intersection == "deepsets":
        put("int_pre", normal_(gen, (d, d), s2, device))
        put("int_pre_b", zeros(d))
        put("int_post", normal_(gen, (d, d), s2, device))
        put("int_post_b", zeros(d))
    return model.to(cfg.dtype)


def _rel_rows(table: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """``table[rel]`` for a scalar or per-query ``[B]`` relation id (ids
    clamped, as the reference's gather clamps them)."""
    return table[rel.long().clamp(0, table.shape[0] - 1)]


def _compose(cfg: GQEConfig, model: GQE, vec: torch.Tensor,
             rel: torch.Tensor) -> torch.Tensor:
    """One relation hop on a batch of vectors ``[B, d]``; ``rel`` is one
    relation id shared by the batch (0-d) or one per query (``[B]``)."""
    if cfg.decoder in ("bilinear", "bibox"):
        w = _rel_rows(model.rel_mat, rel)  # [d, d] or [B, d, d]
        if w.ndim == 3:
            return torch.einsum("bd,bdo->bo", vec, w)
        return vec @ w
    if cfg.decoder == "transe":
        return vec + _rel_rows(model.rel_vec, rel)
    return vec * _rel_rows(model.rel_diag, rel)  # distmult


def _intersect(cfg: GQEConfig, model: GQE,
               branches: List[torch.Tensor]) -> torch.Tensor:
    if len(branches) == 1:
        return branches[0]
    stack = torch.stack(branches, dim=0)  # [K, B, d]
    # amin / amax share the gradient of tied elements, as jnp.min does
    if cfg.intersection == "min":
        return torch.amin(stack, dim=0)
    if cfg.intersection == "mean":
        return torch.mean(stack, dim=0)
    h = torch.relu(torch.einsum("kbd,do->kbo", stack, model.int_pre)
                   + model.int_pre_b)
    pooled = torch.amin(h, dim=0)
    return pooled @ model.int_post + model.int_post_b


def _compose_box(cfg, model, box, rel):
    """One relation hop on a batch of boxes: translate the center, widen
    the offset (relu keeps offsets nonnegative)."""
    c, o = box
    return (c + _rel_rows(model.rel_cen, rel),
            o + torch.relu(_rel_rows(model.rel_off, rel)))


def _intersect_box(cfg, model, boxes):
    """Query2Box intersection: per-dimension attention over the branch
    centers; offsets shrink to ``min(offsets) * sigmoid(DeepSets([c;
    o]))``, so the result lies inside every branch box."""
    if len(boxes) == 1:
        return boxes[0]
    cs = torch.stack([b[0] for b in boxes], dim=0)  # [K, B, d]
    os_ = torch.stack([b[1] for b in boxes], dim=0)
    att = torch.relu(torch.einsum("kbd,do->kbo", cs, model.box_att1)
                     + model.box_att1_b)
    att = torch.einsum("kbd,do->kbo", att, model.box_att2) + model.box_att2_b
    a = torch.softmax(att, dim=0)
    c = torch.sum(a * cs, dim=0)
    x = torch.cat([cs, os_], dim=-1)  # [K, B, 2d]
    h = torch.relu(torch.einsum("kbe,eo->kbo", x, model.box_ds1)
                   + model.box_ds1_b)
    g = torch.sigmoid(torch.mean(h, dim=0) @ model.box_ds2 + model.box_ds2_b)
    return (c, torch.amin(os_, dim=0) * g)


def _compose_bibox(cfg, model, rep, rel):
    """One hop on a ``(vec, (center, offset))`` pair: both heads advance in
    lockstep."""
    vec, box = rep
    return (_compose(cfg, model, vec, rel),
            _compose_box(cfg, model, box, rel))


def _intersect_bibox(cfg, model, reps):
    """DeepSets (or min / mean) on the point head, the Query2Box
    intersection on the box head."""
    if len(reps) == 1:
        return reps[0]
    return (_intersect(cfg, model, [r[0] for r in reps]),
            _intersect_box(cfg, model, [r[1] for r in reps]))


def box_score(cfg: GQEConfig, c: torch.Tensor, o: torch.Tensor,
              e: torch.Tensor) -> torch.Tensor:
    """Query2Box affinity of entity points ``e`` to the box ``(c, o)``
    (broadcast over leading axes): ``-(outside L1 + box_alpha * inside
    L1) / sqrt(d)``, in float32."""
    delta = torch.abs(e.to(torch.float32) - c.to(torch.float32))
    off = torch.relu(o).to(torch.float32)
    # maximum / minimum share the gradient of ties, as jnp's do
    dout = torch.sum(torch.maximum(delta - off, delta.new_zeros(())), dim=-1)
    din = torch.sum(torch.minimum(delta, off), dim=-1)
    return -(dout + cfg.box_alpha * din) / math.sqrt(c.shape[-1])


def box_score_rows(cfg: GQEConfig, box, rows: torch.Tensor) -> torch.Tensor:
    """Scores of a box batch ``([B, d], [B, d])`` against shared candidate
    rows ``[K, d]`` → ``[B, K]``."""
    c, o = box
    return box_score(cfg, c[:, None, :], o[:, None, :], rows[None, :, :])


def box_score_all(model: GQE, cfg: GQEConfig, box) -> torch.Tensor:
    """``[B, n_entities]`` box affinities against the raw float32 entity
    table, in entity chunks sized so one ``[B, chunk, d]`` temporary stays
    near ``BOX_CHUNK_BYTES`` (the box distance has no matmul form; each
    score reduces over d only, so the chunk changes no score)."""
    c, o = box
    ent = model.emb.ent
    n, d = ent.shape
    B = c.shape[0]
    chunk = max(1, BOX_CHUNK_BYTES // (4 * max(B, 1) * d))
    out = torch.empty((B, n), dtype=torch.float32, device=c.device)
    for lo in range(0, n, chunk):
        out[:, lo:lo + chunk] = box_score_rows(cfg, box, ent[lo:lo + chunk])
    return out


def bibox_score(cfg: GQEConfig, rep, e: torch.Tensor) -> torch.Tensor:
    """``cosine(vec, e) + bibox_w * box(c, o, e)``.  ``e`` may carry one
    more leading candidate axis than the ``[B, d]`` representation; the
    query side then broadcasts over it."""
    vec, (c, o) = rep
    if e.ndim == vec.ndim + 1:
        vec, c, o = vec[:, None, :], c[:, None, :], o[:, None, :]
    return (mpqe_mod.score(_score_cfg(cfg), vec, e)
            + cfg.bibox_w * box_score(cfg, c, o, e))


def bibox_score_rows(cfg: GQEConfig, rep, rows: torch.Tensor) -> torch.Tensor:
    """Hybrid scores against shared candidate rows ``[K, d]`` →
    ``[B, K]``."""
    return bibox_score(cfg, rep, rows[None, :, :])


def bibox_score_all(model: GQE, cfg: GQEConfig, rep) -> torch.Tensor:
    """``[B, n_entities]`` hybrid affinities: one cosine matmul for the
    point head plus the chunked box distance for the box head."""
    vec, box = rep
    return (mpqe_mod.score_all_entities(model, _score_cfg(cfg), vec)
            + cfg.bibox_w * box_score_all(model, cfg, box))


def _anchor_embed(model: GQE, cfg: GQEConfig, ids: torch.Tensor,
                  neighbor_table: Optional[Dict[str, torch.Tensor]]
                  ) -> torch.Tensor:
    """Anchor rows: direct lookup, or the neighborhood encoder.  Candidate
    scoring reads the entity table directly either way."""
    ent = model.emb.ent
    if cfg.encoder == "neighborhood":
        if neighbor_table is None:
            raise ValueError(
                "GQEConfig.encoder='neighborhood' needs neighbor_table= "
                "(build_neighbor_table(kg)) threaded into the loss/encode "
                "call")
        return agg_mod.encode_entities(
            model.nbr, ent, neighbor_table["idx"], neighbor_table["mask"],
            ids, cfg.aggregator)
    return mpqe_mod._entity_rows(ent, ids)


def branch_vectors(model: GQE, cfg: GQEConfig, structure: str,
                   node_entity: torch.Tensor, edge_rel: torch.Tensor,
                   neighbor_table: Optional[Dict[str, torch.Tensor]] = None
                   ) -> List[Any]:
    """The composed branches arriving at the target node (the query's
    conjuncts), each ``[B, d]`` (a ``(center, offset)`` pair for box, a
    ``(vec, (center, offset))`` pair for bibox).  ``edge_rel`` is
    ``[n_edges]`` or per query ``[B, n_edges]``."""
    spec = STRUCTURES[structure]
    is_box, is_bibox = cfg.decoder == "box", cfg.decoder == "bibox"
    compose = (_compose_bibox if is_bibox
               else _compose_box if is_box else _compose)
    intersect = (_intersect_bibox if is_bibox
                 else _intersect_box if is_box else _intersect)

    def anchor(ids):
        e = _anchor_embed(model, cfg, ids, neighbor_table)
        if is_bibox:
            return (e, (e, torch.zeros_like(e)))
        return (e, torch.zeros_like(e)) if is_box else e

    node_branches: List[Optional[List[Any]]] = [None] * spec.n_nodes
    for s in spec.anchor_slots:
        node_branches[s] = [anchor(node_entity[:, s])]
    for node in range(spec.n_nodes):
        in_edges = [j for j in range(spec.n_edges) if spec.edge_dst[j] == node]
        if not in_edges:
            continue
        contribs = []
        for j in in_edges:
            src = node_branches[spec.edge_src[j]]
            src_vec = src[0] if len(src) == 1 else intersect(cfg, model, src)
            contribs.append(compose(cfg, model, src_vec, edge_rel[..., j]))
        node_branches[node] = contribs
    return node_branches[spec.target_slot]


def _intersect_any(cfg: GQEConfig, model: GQE, branches):
    """The decoder's intersection of ``branches``."""
    if cfg.decoder == "box":
        return _intersect_box(cfg, model, branches)
    if cfg.decoder == "bibox":
        return _intersect_bibox(cfg, model, branches)
    return _intersect(cfg, model, branches)


def encode_dense(model: GQE, cfg: GQEConfig, structure: str,
                 node_entity: torch.Tensor, node_mode, edge_rel: torch.Tensor,
                 edge_norm, neighbor_table=None):
    """Query representation: the intersected target vector ``[B, d]``
    (a box pair for box, a hybrid pair for bibox).  ``node_mode`` and
    ``edge_norm`` are unused (kept for the MPQE signature)."""
    branches = branch_vectors(model, cfg, structure, node_entity, edge_rel,
                              neighbor_table)
    return _intersect_any(cfg, model, branches)


def encode_dense_multi(model: GQE, cfg: GQEConfig, structure: str,
                       node_entity, node_mode, edge_rel_q, edge_norm_q,
                       neighbor_table=None):
    """Per-query-relation encoding (``edge_rel_q [B, n_edges]``): relation
    hops gather per-query parameters, so queries of many formulas of one
    structure encode in one call."""
    return encode_dense(model, cfg, structure, node_entity, node_mode,
                        edge_rel_q, None, neighbor_table)


def _min_over(scores: List[torch.Tensor]) -> torch.Tensor:
    return torch.amin(torch.stack(scores, dim=0), dim=0)


def score_rep(cfg: GQEConfig, rep, cand: torch.Tensor,
               expand: bool) -> torch.Tensor:
    """Score one representation against candidate rows ``cand`` (``[B,
    d]``, or ``[B, K, d]`` with ``expand``)."""
    if cfg.decoder == "bibox":
        return bibox_score(cfg, rep, cand)
    if cfg.decoder == "box":
        c, o = rep
        if expand:
            c, o = c[:, None, :], o[:, None, :]
        return box_score(cfg, c, o, cand)
    q = rep[:, None, :] if expand else rep
    return mpqe_mod.score(_score_cfg(cfg), q, cand)


def _score_branches(cfg: GQEConfig, model: GQE, branches, cand, expand):
    """SoftAnd: the minimum over the branches' scores; otherwise the
    score of their intersection."""
    if cfg.soft_and:
        return _min_over([score_rep(cfg, b, cand, expand)
                          for b in branches])
    return score_rep(cfg, _intersect_any(cfg, model, branches), cand, expand)


def score_pos_neg(model: GQE, cfg: GQEConfig, structure: str,
                  node_entity: torch.Tensor, edge_rel: torch.Tensor,
                  target: torch.Tensor, negatives: torch.Tensor,
                  neighbor_table=None):
    """(pos scores ``[B]``, neg scores ``[B, K]``) with the branches
    computed once; SoftAnd takes the conjunct minimum."""
    ent = model.emb.ent
    branches = branch_vectors(model, cfg, structure, node_entity, edge_rel,
                              neighbor_table)
    pos = _score_branches(cfg, model, branches,
                          mpqe_mod._entity_rows(ent, target), False)
    neg = _score_branches(cfg, model, branches,
                          mpqe_mod._entity_rows(ent, negatives), True)
    return pos, neg


def score_queries(model: GQE, cfg: GQEConfig, structure: str,
                  node_entity: torch.Tensor, edge_rel: torch.Tensor,
                  targets: torch.Tensor,
                  neighbor_table=None) -> torch.Tensor:
    """Affinities of the queries to ``targets`` (``[B]`` or ``[B, K]``);
    SoftAnd scores each conjunct and takes the minimum."""
    cand = mpqe_mod._entity_rows(model.emb.ent, targets)
    branches = branch_vectors(model, cfg, structure, node_entity, edge_rel,
                              neighbor_table)
    return _score_branches(cfg, model, branches, cand, targets.ndim > 1)


def score_all(model: GQE, cfg: GQEConfig, rep,
              ent_norm_t: Optional[torch.Tensor] = None,
              table_dtype: str = "float32") -> torch.Tensor:
    """``[B, n_entities]`` affinities of one representation: the cosine
    rank product (against ``ent_norm_t``, the normalized transposed table
    in ``table_dtype``, when given), the chunked box distance, or both
    for bibox."""
    def cosine(vec):
        if ent_norm_t is None:
            return mpqe_mod.score_all_entities(model, _score_cfg(cfg), vec)
        vec = vec.to(torch.float32)
        if cfg.scale_scores:
            vec = mpqe_mod._l2_normalize(vec)
        return quantized_scores(vec, ent_norm_t, table_dtype)

    if cfg.decoder == "bibox":
        vec, box = rep
        return cosine(vec) + cfg.bibox_w * box_score_all(model, cfg, box)
    if cfg.decoder == "box":
        return box_score_all(model, cfg, rep)
    return cosine(rep)


def rank_scores(model: GQE, cfg: GQEConfig, structure: str, node_entity,
                edge_rel_q, neighbor_table=None,
                ent_norm_t: Optional[torch.Tensor] = None,
                table_dtype: str = "float32") -> torch.Tensor:
    """``[B, n_entities]`` scores of a per-query-relation batch against
    every entity (the full-ranking and serving sweep): SoftAnd keeps a
    running minimum over the branches' score matrices, one matrix alive
    at a time."""
    branches = branch_vectors(model, cfg, structure, node_entity, edge_rel_q,
                              neighbor_table)
    if not cfg.soft_and:
        return score_all(model, cfg, _intersect_any(cfg, model, branches),
                         ent_norm_t, table_dtype)
    out = None
    for b in branches:
        s = score_all(model, cfg, b, ent_norm_t, table_dtype)
        out = s if out is None else torch.minimum(out, s)
    return out


def _score_cfg(cfg: GQEConfig) -> mpqe_mod.MPQEConfig:
    return mpqe_mod.MPQEConfig(
        n_entities=cfg.n_entities, n_modes=cfg.n_modes, n_rels=cfg.n_rels,
        embed_dim=cfg.embed_dim, margin=cfg.margin,
        scale_scores=cfg.scale_scores)


def dense_batch_loss(model: GQE, cfg: GQEConfig, structure: str,
                     node_entity, node_mode, edge_rel, edge_norm, target,
                     negatives, neg_mask, query_mask,
                     neighbor_table=None) -> torch.Tensor:
    """Margin ranking loss, the MPQE protocol: ``mean(relu(margin - pos +
    neg))`` over the real (query, negative) pairs, the branches encoded
    once for positives and negatives."""
    pos, neg = score_pos_neg(model, cfg, structure, node_entity, edge_rel,
                             target, negatives, neighbor_table)
    viol = torch.relu(cfg.margin - pos[:, None] + neg)
    w = neg_mask * query_mask[:, None]
    return torch.sum(viol * w) / torch.clamp(torch.sum(w), min=1.0)
