"""Sparse layouts of a dense template batch, built on the device
(counterpart of ``mpqe_tpu/ops/template_layout.py``).

A dense template batch (B same-structure queries sharing ``edge_rel
[n_edges]`` and ``edge_norm [n_edges]``) fully determines its batched
query graph, so the layouts the sparse kernels consume are made from
``arange`` on the batch's device: no host work per step.

* :func:`template_chunked`: the relation-chunk-aligned layout of
  ``ops/rgcn_fused.py`` (K5).  Edge ``(j, b)`` sits at ``j * B + b``, so
  every chunk of ``chunk`` edges carries one relation by construction.
* :func:`template_blocked`: the (dst block, src block) layout of
  ``ops/rgcn_blocked.py`` (K6).  A node block of ``Q`` whole queries puts
  every edge's src and dst in the same block: purely diagonal buckets, no
  padding, query-major edge order.  The transpose-graph ``t_*`` arrays of
  the backward are the same layout with the local ids swapped.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from mpqe_tpu_torch.queries import STRUCTURES


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def template_chunked(structure: str, edge_rel: torch.Tensor,
                     edge_norm: torch.Tensor, batch_size: int,
                     chunk: int = 512) -> Dict[str, object]:
    """Relation-chunk-aligned edge layout of a dense template batch, on
    ``edge_rel``'s device.  Node ids are ``b * n + slot``; ``chunk`` is
    clipped to B and must divide it."""
    spec = STRUCTURES[structure]
    B, n = batch_size, spec.n_nodes
    chunk = min(chunk, B)
    if B % chunk:
        raise ValueError(f"chunk {chunk} must divide batch size {B}")
    dev = edge_rel.device
    src_slot = torch.tensor(spec.edge_src, dtype=torch.int32, device=dev)
    dst_slot = torch.tensor(spec.edge_dst, dtype=torch.int32, device=dev)
    offs = _iota(B, dev) * n
    src = (src_slot[:, None] + offs[None, :]).reshape(-1)
    dst = (dst_slot[:, None] + offs[None, :]).reshape(-1)
    norm = torch.repeat_interleave(edge_norm.to(torch.float32), B)
    chunk_rel = torch.repeat_interleave(edge_rel.to(torch.int32), B // chunk)
    return {"src": src, "dst": dst, "norm": norm, "chunk_rel": chunk_rel,
            "chunk": chunk}


def blocked_geometry(structure: str, batch_size: int,
                     queries_per_block: int = 512,
                     chunk: int = 512) -> Dict[str, int]:
    """Static shape parameters of the diagonal blocked layout: a node block
    of ``sb = Q * n`` rows (Q whole queries, Q clipped to B and halved
    until it divides B), ``sb`` and the chunk 8-divisible, the chunk a
    divisor of the per-block edge count (the reference's rules)."""
    spec = STRUCTURES[structure]
    B, n, ne = batch_size, spec.n_nodes, spec.n_edges
    q = min(queries_per_block, B)
    while B % q:
        q //= 2
    sb = q * n
    if sb % 8:
        while (q * n) % 8 and q > 1:
            q //= 2
        if (q * n) % 8:
            raise ValueError(f"cannot tile structure {structure} (n={n})")
        sb = q * n
    per_block = q * ne
    c = min(chunk, per_block)
    while per_block % c or c % 8:
        c //= 2
        if c < 8:
            raise ValueError(f"no valid chunk for {structure} B={B} Q={q}")
    return {"q_per_block": q, "node_block": sb, "chunk": c,
            "n_blocks": B // q, "chunks_per_block": per_block // c}


def template_blocked(structure: str, edge_rel: torch.Tensor,
                     edge_norm: torch.Tensor, batch_size: int,
                     queries_per_block: int = 512,
                     chunk: int = 512) -> Dict[str, object]:
    """(dst block, src block) bucketed layout of a dense template batch,
    transpose arrays included, on ``edge_rel``'s device.  Query-major
    edge order ``(b, j)``; block-local node ids ``(b % Q) * n + slot``;
    ``chunk_src_blk == chunk_dst_blk``."""
    spec = STRUCTURES[structure]
    B, n = batch_size, spec.n_nodes
    g = blocked_geometry(structure, B, queries_per_block, chunk)
    q, sb, c = g["q_per_block"], g["node_block"], g["chunk"]
    n_blocks, cpb = g["n_blocks"], g["chunks_per_block"]
    dev = edge_rel.device

    src_slot = torch.tensor(spec.edge_src, dtype=torch.int32, device=dev)
    dst_slot = torch.tensor(spec.edge_dst, dtype=torch.int32, device=dev)
    local_off = (_iota(B, dev) % q) * n
    src_l = (local_off[:, None] + src_slot[None, :]).reshape(-1)
    dst_l = (local_off[:, None] + dst_slot[None, :]).reshape(-1)
    rel = edge_rel.to(torch.int32).repeat(B)
    norm = edge_norm.to(torch.float32).repeat(B)

    n_chunks = n_blocks * cpb
    blk = torch.div(_iota(n_chunks, dev), cpb, rounding_mode="floor")
    first = (_iota(n_chunks, dev) % cpb == 0).to(torch.int32)
    return {
        "src_local": src_l, "dst_local": dst_l, "rel": rel, "norm": norm,
        "chunk_src_blk": blk, "chunk_dst_blk": blk, "chunk_first": first,
        "t_src_local": dst_l, "t_dst_local": src_l, "t_rel": rel,
        "t_norm": norm, "t_chunk_src_blk": blk, "t_chunk_dst_blk": blk,
        "t_chunk_first": first,
        "node_block": sb, "chunk": c, "n_blocks": n_blocks,
    }


@functools.lru_cache(maxsize=None)
def _blocked_layouts_of_geometry(structure: str, batch_size: int,
                                 queries_per_block: int, chunk: int,
                                 device: torch.device) -> tuple:
    """``layouts_on`` of the template's blocked layout with relation 0 and
    norm 1 on every edge: the edge orders, which do not change from batch
    to batch (kept for the life of the process)."""
    from mpqe_tpu_torch.ops import rgcn_blocked

    ne = STRUCTURES[structure].n_edges
    bk = template_blocked(
        structure, torch.zeros((ne,), dtype=torch.int32, device=device),
        torch.ones((ne,), device=device), batch_size, queries_per_block,
        chunk)
    return rgcn_blocked.layouts_on(bk, device)


def template_blocked_layouts(structure: str, edge_rel: torch.Tensor,
                             edge_norm: torch.Tensor, batch_size: int,
                             queries_per_block: int = 512,
                             chunk: int = 512) -> tuple:
    """``rgcn_blocked.layouts_on(template_blocked(...))`` (the forward and
    transpose layouts with K6's edge lists) on ``edge_rel``'s device, from
    cached edge orders: per batch only the relations and norms are placed
    (``rgcn_blocked.relabeled``)."""
    from mpqe_tpu_torch.ops import rgcn_blocked

    lay, t_lay = _blocked_layouts_of_geometry(
        structure, batch_size, queries_per_block, chunk, edge_rel.device)
    rel = edge_rel.to(torch.int32).repeat(batch_size)
    norm = edge_norm.to(torch.float32).repeat(batch_size)
    return (rgcn_blocked.relabeled(lay, rel, norm),
            rgcn_blocked.relabeled(t_lay, rel, norm))
