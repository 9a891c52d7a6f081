"""Candidate scoring under the table's dtype, and the full rank and top-k
over a row-sharded entity table (counterpart of
``mpqe_tpu/parallel/rank_shard.py``).

The float32, bfloat16 and int8 candidate tables of the rank product have
their formulas in one place (:func:`quantized_scores`,
:func:`quantize_rows`, :func:`quantize_table`), for the single-device
server and the sharded path alike.  The rank product stays a library
call, as the reference leaves it to XLA outside any Pallas kernel:
``torch.mm`` for float32 and bfloat16 (an f32 result from bf16 operands:
``out_dtype=torch.float32`` on the card, operands taken up to f32 on the
CPU), ``torch._int_mm`` for int8 (int32 sums, exact here).

Over a table split by rows into one block per model-axis part (the
reference's ``shard_map`` over the ``model`` axis), no ``[B,
n_entities]`` score matrix exists on any device:

* each part scores the batch against its own block (``[B, N/s]`` on its
  device; cosine normalization is per row, so a block's own is exact);
* **rank** (:func:`make_sharded_rank_fn`): the true answer's score and
  mode come from the part that owns the target row, and the rank is 1 +
  the parts' counts of same-mode candidates scoring strictly above it,
  summed: the semantics of ``train/evaluation.full_ranking``;
* **top-k** (:func:`make_sharded_topk_fn`): a local top-k per part
  (``serve.top_k``, ``lax.top_k``'s tie order), the ``s x k`` candidates
  gathered onto one device and merged.  Where a mode has fewer than k
  candidates the tail comes back as ``(-inf, -1)``, never a
  wrong-mode or pad row.

The blocks and their mode vectors come from :func:`shard_table` /
:func:`shard_modes` (pad rows have mode -1, which matches no query), or
are the encode table's own (``parallel/sharding.py RowShardedTable``,
:func:`shard_encode_params`).  The per-part functions run one after
another from one controller; the parts' results are moved with
``.to(device)``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from mpqe_tpu_torch.parallel import mesh as mesh_lib

TABLE_DTYPES = ("float32", "bfloat16", "int8")

# torch._int_mm on the card: rows of the first operand above this, and
# the inner and column counts multiples of 8
INT_MM_MIN_ROWS = 17


def check_table_dtype(table_dtype: str) -> None:
    """``ValueError`` for a table dtype the rank product does not take."""
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(f"unknown table_dtype {table_dtype!r}")


def _int8_scores(q8: torch.Tensor, table_t: torch.Tensor) -> torch.Tensor:
    """``q8 [B, d] @ table_t [d, N]`` with int32 sums.  On the card
    ``torch._int_mm`` wants more than 16 rows and d and N multiples of 8:
    a smaller batch is padded with zero rows, and a width it does not
    take raises."""
    if q8.is_cuda:
        d, n = table_t.shape
        if d % 8 or n % 8:
            raise ValueError(
                f"int8 rank product on the card needs d and n_entities "
                f"multiples of 8, got d={d}, n_entities={n}")
        B = q8.shape[0]
        if B < INT_MM_MIN_ROWS:
            q8 = torch.cat([q8, q8.new_zeros((INT_MM_MIN_ROWS - B, d))])
            return torch._int_mm(q8, table_t)[:B]
    return torch._int_mm(q8, table_t)


def quantized_scores(q: torch.Tensor, table_t: torch.Tensor,
                     table_dtype: str) -> torch.Tensor:
    """``[B, N]`` f32 scores ``q @ table_t`` under the table's dtype.
    ``q`` is f32 (normalized by the caller when cosine-scoring),
    ``table_t`` the ``[d, N]`` table from :func:`quantize_rows`:

    * int8: ``q8 = round(clip(q, -1, 1) * 127)`` (round half to even, as
      ``jnp.round``), int32 sums (``127² · d`` is far inside int32, so they
      are exact), times ``1 / 127²``: bit-equal to the reference;
    * bfloat16: ``bf16(q) @ table_t`` with an f32 result (the products
      are exact in f32; only the sum order differs from the reference's);
    * float32: ``q @ table_t`` in f32 (TF32 off, the card's default)."""
    check_table_dtype(table_dtype)
    if table_dtype == "int8":
        q8 = torch.round(torch.clamp(q, -1.0, 1.0) * 127.0).to(torch.int8)
        s = _int8_scores(q8, table_t)
        return s.to(torch.float32) * (1.0 / (127.0 * 127.0))
    if table_dtype == "bfloat16":
        from mpqe_tpu_torch.ops.dtypes import dot_f32

        return dot_f32(q.to(torch.bfloat16), table_t)
    return torch.matmul(q, table_t)


def quantize_rows(ent_norm: torch.Tensor, table_dtype: str) -> torch.Tensor:
    """Quantize PRE-normalized candidate rows: bfloat16 rounds them,
    int8 takes ``round(x * 127)``, float32 leaves them."""
    if table_dtype == "bfloat16":
        return ent_norm.to(torch.bfloat16)
    if table_dtype == "int8":
        return torch.round(ent_norm * 127.0).to(torch.int8)
    if table_dtype == "float32":
        return ent_norm
    raise ValueError(f"unknown table_dtype {table_dtype!r}")


def quantize_table(ent: torch.Tensor, table_dtype: str,
                   scale: bool) -> torch.Tensor:
    """Pre-normalize (cosine) and quantize candidate rows, as the
    reference's sharded path prepares them; float32 returns the raw
    table (normalized per dispatch there)."""
    if table_dtype == "float32":
        return ent
    if table_dtype == "int8" and not scale:
        raise ValueError(
            "table_dtype='int8' needs cosine scoring (normalized rows)")
    if scale:
        ent = ent / (torch.linalg.vector_norm(ent, dim=-1, keepdim=True)
                     + 1e-12)
    return quantize_rows(ent, table_dtype)


# ----------------------------------------------------------------------
# The sharded rank and top-k
# ----------------------------------------------------------------------
def _local_scores(table_l: torch.Tensor, q: torch.Tensor, scale: bool,
                  table_dtype: str = "float32") -> torch.Tensor:
    """``[B, N_l]`` f32 scores against one part's rows.  A float32 table
    is the raw (encode) table, taken to f32 and normalized here per
    dispatch; quantized tables come normalized and quantized from
    :func:`quantize_table`."""
    q = q.to(torch.float32)
    if scale:
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        if table_dtype == "float32":
            table_l = table_l.to(torch.float32)
            table_l = table_l / (torch.linalg.vector_norm(
                table_l, dim=-1, keepdim=True) + 1e-12)
    elif table_dtype == "float32":
        table_l = table_l.to(torch.float32)
    return quantized_scores(q, table_l.t(), table_dtype)


def _model_devices(mesh) -> List[torch.device]:
    return mesh.axis_devices(mesh_lib.model_axis(mesh))


def make_sharded_rank_fn(mesh, cfg):
    """``fn(tables, modes, q, target) -> ranks [B]`` (int64, on ``q``'s
    device).  ``tables``: one ``[N_l, d]`` block per model-axis part
    (equal ``N_l``, padded), ``modes`` their ``[N_l]`` mode blocks (pad
    rows -1); ``q [B, d]`` and ``target [B]`` on any device.  Candidates
    are the target's mode (other true answers still compete: unfiltered
    ranking)."""
    scale = bool(cfg.scale_scores)
    devices = _model_devices(mesh)

    def fn(tables: Sequence[torch.Tensor], modes: Sequence[torch.Tensor],
           q: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        out_dev = q.device
        with torch.no_grad():
            scores, true_s, t_mode = [], [], []
            for p, dev in enumerate(devices):
                table_l = tables[p]
                n_l = table_l.shape[0]
                lo = p * n_l
                tgt = target.to(dev).long()
                s_l = _local_scores(table_l, q.to(dev), scale)
                il = (tgt - lo).clamp(0, n_l - 1)
                owned = (tgt >= lo) & (tgt < lo + n_l)
                picked = s_l.gather(1, il[:, None])[:, 0]
                scores.append(s_l)
                true_s.append(torch.where(owned, picked,
                                          picked.new_zeros(())))
                t_mode.append(torch.where(owned, modes[p].to(dev)[il].long(),
                                          il.new_zeros(())))
            true_s = mesh_lib.psum(true_s, devices)
            t_mode = mesh_lib.psum(t_mode, devices)
            counts = []
            for p, dev in enumerate(devices):
                ok = modes[p].to(dev)[None, :].long() == t_mode[p][:, None]
                counts.append(torch.sum((scores[p] > true_s[p][:, None])
                                        & ok, dim=1))
            return 1 + mesh_lib.psum(counts, [out_dev])[0]

    return fn


def make_sharded_topk_fn(mesh, cfg, k: int, table_dtype: str = "float32"):
    """``fn(tables, modes, q, answer_mode) -> (scores [B, k], ids [B,
    k])`` on ``q``'s device: the serving answer of a row-sharded table.
    Candidates outside ``answer_mode`` score ``-inf``; ids of ``-inf``
    entries are -1.  A quantized ``table_dtype`` takes
    :func:`quantize_table`'s blocks."""
    from mpqe_tpu_torch.serve import top_k

    check_table_dtype(table_dtype)
    scale = bool(cfg.scale_scores)
    devices = _model_devices(mesh)

    def fn(tables: Sequence[torch.Tensor], modes: Sequence[torch.Tensor],
           q: torch.Tensor, answer_mode: torch.Tensor):
        out_dev = q.device
        with torch.no_grad():
            vals, ids = [], []
            for p, dev in enumerate(devices):
                table_l = tables[p]
                n_l = table_l.shape[0]
                s_l = _local_scores(table_l, q.to(dev), scale, table_dtype)
                ok = modes[p].to(dev)[None, :].long() == \
                    answer_mode.to(dev).long()[:, None]
                s_l.masked_fill_(~ok, float("-inf"))
                v_l, i_l = top_k(s_l, min(k, n_l))
                vals.append(v_l.to(out_dev))
                ids.append((i_l + p * n_l).to(out_dev))
            # per query, every part's candidates in part order (the
            # reference's all_gather), then the merge
            v_c = torch.cat(vals, dim=1)
            i_c = torch.cat(ids, dim=1)
            v_top, sel = top_k(v_c, k)
            ids_top = i_c.gather(1, sel)
            return v_top, torch.where(torch.isfinite(v_top), ids_top,
                                      ids_top.new_full((), -1))

    return fn


def shard_encode_params(model, mesh):
    """The encode side of a model with its entity table row-sharded over
    the model axis (``sharding.RowShardedTable``: padded with zero rows
    to a multiple of its size; pad rows are never gathered for an id
    below ``n_entities``) and its other parameters on the mesh's first
    device: the layout the ``--parallel spmd`` train step leaves the
    table in.  A copy: ``model`` is not changed, and its table is not
    copied whole.  A model whose table is already sharded over the
    mesh's model axis is returned as it is."""
    import copy

    from mpqe_tpu_torch.parallel import sharding as sharding_lib

    ent = model.emb.ent
    devices = _model_devices(mesh)
    if isinstance(ent, sharding_lib.RowShardedTable):
        if ent.devices != devices:
            raise ValueError(f"the entity table is sharded over "
                             f"{ent.devices}, the mesh's model axis is "
                             f"{devices}")
        return model
    out = copy.deepcopy(model, {id(ent): None})
    out._logical_names = tuple(n for n, _ in model.named_parameters())
    out.to(mesh.devices.flat[0])
    sharding_lib.attach_table(out.emb, "ent", sharding_lib.RowShardedTable(
        ent, devices, requires_grad=ent.requires_grad))
    return out


def shard_modes(mesh, entity_mode, n_rows: int, pad_mode: int = -1
                ) -> List[torch.Tensor]:
    """The mode vector padded to ``n_rows`` with ``pad_mode`` (no real
    mode, so pad rows never enter a rank count and only appear in a
    top-k as the ``(-inf, -1)`` tail), split into one int32 block per
    model-axis part, on its device."""
    devices = _model_devices(mesh)
    m = torch.as_tensor(np.asarray(entity_mode, dtype=np.int32))
    if n_rows != m.shape[0]:
        m = torch.cat([m, torch.full((n_rows - m.shape[0],), pad_mode,
                                     dtype=m.dtype)])
    return mesh_lib.scatter_blocks(m, devices)


def shard_table(mesh, ent: torch.Tensor, entity_mode, pad_mode: int = -1
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    """Row-sharded copies of a table and its mode vector on the model
    axis, in ``sharding.block_rows``' layout: rows padded with zeros to
    s equal blocks, and an int8 table's blocks to a multiple of 8 rows
    (the card's int8 product wants it; pad rows change no answer);
    returns ``(blocks, mode blocks, n_padded)``."""
    from mpqe_tpu_torch.parallel import sharding as sharding_lib

    devices = _model_devices(mesh)
    s = len(devices)
    per = sharding_lib.block_rows(ent.shape[0], s,
                                  8 if ent.dtype == torch.int8 else 1)
    with torch.no_grad():
        blocks = [b.to(dev).contiguous() for b, dev in
                  zip(sharding_lib.split_rows(ent.detach(), per, s), devices)]
    return blocks, shard_modes(mesh, entity_mode, per * s, pad_mode), per * s
