"""Every multi-part path once, at tiny shapes, on an N-part mesh
(counterpart of the root ``__graft_entry__.py dryrun_multichip``).

On the ``(N / m, m)`` mesh (m = 2 when N is even, else 1) it runs:

1. the data-parallel train step (``parallel/spmd.py``) with the entity
   table and the relation weights row-sharded over the model axis;
2. the edge-partitioned layers ``rgcn_dst_partitioned`` (data axis),
   with m > 1 ``rgcn_rel_partitioned`` (model axis) and
   ``rgcn_2d_partitioned`` (both);
3. ``rgcn_ring_halo`` (the ``ppermute`` ring) and K8
   (``ops/ring.py rgcn_ring_halo_rdma``) on the data-axis ring, held to
   it at 1e-4;
4. a train step through the ring halo layers;
5. the step's state (both tables row-sharded) encodes the batch's
   queries through K3 (``ops/fused_fwd.py``, its anchor rows and
   relation coefficients gathered from their owner blocks), bit-equal to
   K3 on the same parameters unsharded, and the sharded full rank and
   top-k (``parallel/rank_shard.py``) rank them over its table.

It prints ``dryrun_multichip ok: mesh={'data': ..., 'model': ...}
loss=... devices=[...]``.  On the card (``--device cuda``, the default)
the N parts are the first N visible cards, as the reference takes
``jax.devices()[:n_devices]`` (fewer cards exit naming the count); a
``--device`` that names one card (``cuda:0``) puts the N parts on that
card (a ring of parts on one card: each keeps its own buffers and
receives the others' only by copies); ``--device cpu`` puts them on the
CPU, where K8 is its plain version.

  python -m mpqe_tpu_torch.tools.dryrun_multichip --n_devices 4
  python -m mpqe_tpu_torch.tools.dryrun_multichip --n_devices 8 \\
      --device cuda:0
  python -m mpqe_tpu_torch.tools.dryrun_multichip --n_devices 6 \\
      --device cpu
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def part_devices(n_devices: int, device="cuda") -> list:
    """The parts' devices: the first ``n_devices`` visible cards for a
    bare ``cuda`` (``SystemExit`` when there are fewer), else
    ``n_devices`` parts of the one device ``device`` names."""
    from mpqe_tpu_torch.serve import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise SystemExit(f"dryrun_multichip: {n_devices} parts need "
                             f"that many cards, have {have} (--device "
                             "cuda:0 puts them on one card)")
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [dev] * n_devices


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the paths above on ``n_devices`` parts (:func:`part_devices`);
    returns ``{"mesh", "loss", "halo_loss", "k8_err", "devices"}`` and
    raises on a failed check."""
    from mpqe_tpu_torch.data.batcher import DenseQueryBatch
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import fused_fwd
    from mpqe_tpu_torch.ops import rgcn as rgcn_ops
    from mpqe_tpu_torch.ops import ring as ring_ops
    from mpqe_tpu_torch.ops.edge_store import build_edge_store
    from mpqe_tpu_torch.parallel import halo, halo_train, rank_shard, spmd
    from mpqe_tpu_torch.parallel import mesh as mesh_lib
    from mpqe_tpu_torch.queries import STRUCTURES
    from mpqe_tpu_torch.train import loop as loop_mod

    devices = part_devices(n_devices, device)
    dev = devices[0]
    model_size = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = mesh_lib.make_mesh((n_devices // model_size, model_size),
                              devices=devices)
    n_rels = 8 * model_size
    batch_size = 4 * (n_devices // model_size)
    cfg = mpqe_mod.MPQEConfig(
        n_entities=64 * n_devices, n_modes=2, n_rels=n_rels, embed_dim=32,
        n_layers=2, num_bases=4, readout="tgt")
    tc = loop_mod.TrainConfig(lr=0.01, batch_size=batch_size, n_neg=2)

    spec = STRUCTURES["3-chain_inter"]
    rng = np.random.default_rng(0)
    B = batch_size
    batch = DenseQueryBatch(
        structure="3-chain_inter", n_queries=B,
        node_entity=rng.integers(0, cfg.n_entities,
                                 (B, spec.n_nodes)).astype(np.int32),
        node_mode=rng.integers(0, cfg.n_modes,
                               (B, spec.n_nodes)).astype(np.int32),
        edge_rel=rng.integers(0, n_rels, (spec.n_edges,)).astype(np.int32),
        edge_norm=np.ones((spec.n_edges,), np.float32),
        target=rng.integers(0, cfg.n_entities, (B,)).astype(np.int32),
        negatives=rng.integers(0, cfg.n_entities, (B, 2)).astype(np.int32),
        neg_mask=np.ones((B, 2), np.float32),
        query_mask=np.ones((B,), np.float32))

    # 1) the data-parallel step: DP (batch), TP (entity table), EP
    #    (relation weights)
    gen = torch.Generator(device=dev).manual_seed(0)
    init_fn, step = spmd.make_spmd_train_step(
        cfg, tc, mesh, shard_entity_table=True, shard_relations=True)
    state = init_fn(gen)
    loss = spmd.spmd_train_step(step, state, mesh, batch)
    if not math.isfinite(loss):
        raise AssertionError("sharded train step produced NaN")

    # 2) the edge-partitioned layers
    n_nodes, n_e = 16 * n_devices, 64 * n_devices
    st = build_edge_store(rng.integers(0, n_nodes, n_e).astype(np.int32),
                          rng.integers(0, n_nodes, n_e).astype(np.int32),
                          rng.integers(0, n_rels, n_e).astype(np.int32),
                          n_nodes, n_rels)
    layer = rgcn_ops.init_rgcn_layer(gen, cfg.embed_dim, cfg.embed_dim,
                                     n_rels, 4, device=dev)
    x = rng.normal(size=(n_nodes, cfg.embed_dim)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with torch.no_grad():
        pe = halo.partition_edges_by_dst(st, n_parts=mesh.shape["data"])
        x_pad = t(halo.pad_node_features(x, pe))
        pe_t = [t(a) for a in (pe.src, pe.dst_local, pe.rel, pe.norm)]
        outs = [halo.rgcn_dst_partitioned(mesh, layer, x_pad, *pe_t, n_rels)]
        if mesh.shape["model"] > 1:
            outs.append(halo.rgcn_rel_partitioned(
                mesh, layer, t(x), t(st.src), t(st.dst), t(st.rel),
                t(st.norm), n_rels))
            outs.append(halo.rgcn_2d_partitioned(mesh, layer, x_pad, *pe_t,
                                                 n_rels))

        # 3) the ring, and K8 against it on the data-axis ring
        pr = halo.partition_edges_ring(st, n_parts=mesh.shape["data"])
        x_pad_r = np.zeros((pr.n_nodes_padded, cfg.embed_dim), np.float32)
        x_pad_r[:n_nodes] = x
        pr_t = [t(a) for a in (pr.src_local, pr.dst_local, pr.rel, pr.norm)]
        ring = halo.rgcn_ring_halo(mesh, layer, t(x_pad_r), *pr_t, n_rels)
        ring_mesh = mesh_lib.make_mesh(
            (mesh.shape["data"], 1), devices=mesh.axis_devices("data"))
        k8 = ring_ops.rgcn_ring_halo_rdma(ring_mesh, layer, t(x_pad_r),
                                          *pr_t, n_rels)
        outs += [ring, k8]
    for o in outs:
        if not bool(torch.isfinite(o).all()):
            raise AssertionError("a partitioned layer produced NaN")
    k8_err = float((k8 - ring).abs().max())
    scale = float(ring.abs().max())
    if k8_err > 1e-4 * max(scale, 1.0):
        raise AssertionError(f"K8 vs rgcn_ring_halo: max|diff| {k8_err:.3e}")

    # 4) a train step through the ring halo layers
    h_state = halo_train.init_halo_train_state(
        torch.Generator(device=dev).manual_seed(2), cfg, tc, mesh)
    h_step = halo_train.make_halo_train_step(cfg, h_state.optimizer, mesh,
                                             layer_kind="ring")
    h_loss = loop_mod.run_step(h_step, h_state, batch)
    if not math.isfinite(h_loss):
        raise AssertionError("halo train step produced NaN")

    # 5) K3 from the step's sharded state against the same parameters
    #    unsharded, then the sharded rank and top-k of its encodings
    plain = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(3),
                               cfg, device=dev)
    plain.load_state_dict(state.model.state_dict())
    args = [t(batch.node_entity), t(batch.node_mode),
            t(np.broadcast_to(batch.edge_rel, (B, spec.n_edges))),
            t(np.broadcast_to(batch.edge_norm, (B, spec.n_edges)))]
    with torch.no_grad():
        q, q_plain = (mpqe_mod.encode_dense_multi_auto(
            m, cfg, batch.structure, *args,
            operands=fused_fwd.prepare_fused_multi(m, cfg))
            for m in (state.model, plain))
    if not torch.equal(q, q_plain):
        raise AssertionError("K3 from the sharded state differs from K3 "
                             "unsharded")
    entity_mode = rng.integers(0, cfg.n_modes,
                               cfg.n_entities).astype(np.int32)
    table = state.model.emb.ent
    modes = rank_shard.shard_modes(mesh, entity_mode, table.n_padded)
    q = q.to(torch.float32)
    target = t(batch.target)
    ranks = rank_shard.make_sharded_rank_fn(mesh, cfg)(table.blocks, modes,
                                                        q, target)
    tv, _ = rank_shard.make_sharded_topk_fn(mesh, cfg, 5)(
        table.blocks, modes, q, t(entity_mode)[target.long()])
    if int(ranks.min()) < 1 or not bool(torch.isfinite(tv).all()):
        raise AssertionError("sharded rank / top-k")
    return {"mesh": dict(mesh.shape), "loss": loss, "halo_loss": h_loss,
            "k8_err": k8_err, "devices": [str(d) for d in devices]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_devices", type=int, required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda: the first --n_devices cards; a card "
                        "(cuda:0) or cpu: that many parts of it")
    args = p.parse_args(argv)
    out = dryrun_multichip(args.n_devices, args.device)
    print(f"dryrun_multichip ok: mesh={out['mesh']} loss={out['loss']:.4f} "
          f"devices={out['devices']}", flush=True)
    return out


if __name__ == "__main__":
    main()
