"""A few steps of the data-parallel step (``parallel/spmd.py``) or of the
halo step (``parallel/halo_train.py``) in one process of a
``torch.distributed`` group, on random batches made from a seed, the
counterpart of the reference's ``tests/_multihost_worker.py``.  With
``--parallel spmd`` (the default) each process builds its own mesh and
feeds its slice of every global batch (``multihost.host_local_batch``);
with ``--parallel halo_ring|halo_gather`` the processes' meshes join into
one (``multihost.global_mesh``, ``--mesh`` being each process's share of
it, stacked on the data axis), each process holds its own parts of the
halo layers and every process feeds the whole global batch.  Each
process writes its losses and, with ``--params``, its parameters'
changes as an ``.npz``.  Run one process per rank, with ``torchrun``
(``initialize`` reads its variables) or with an address, a count and a
rank:

  torchrun --nproc_per_node 2 -m mpqe_tpu_torch.tools.multihost_run \\
      --device cpu --out runs/mh
  torchrun --nproc_per_node 2 -m mpqe_tpu_torch.tools.multihost_run \\
      --device cpu --parallel halo_ring --out runs/mh_ring
  python -m mpqe_tpu_torch.tools.multihost_run --coordinator 127.0.0.1:29500 \\
      --num_processes 2 --process_id 0 --backend gloo --out runs/mh

Without a group (one process, no variables) it takes the steps over the
whole global batch: the run the group's must equal.  NCCL (the default
on the card) takes one card per rank, each rank its own (``--device
cuda``: rank r on card r; ``--device cuda:k`` names it), and refuses two
ranks on one card; two processes on one card name ``--backend gloo``.
Within a node the halo layers' CUDA blocks cross by ``parallel/ipc.py``;
between nodes (``torchrun --nnodes N --node_rank i``, whose node rank
``GROUP_RANK`` tells the nodes apart) by NCCL.  Two node groups of one
host, each over its own cards, NCCL's peer-to-peer and shared-memory
transports off so that its traffic between them goes by sockets, as
between hosts without InfiniBand (node i of 2, here two cards and two
processes a node):

  CUDA_VISIBLE_DEVICES=<node i's cards> NCCL_P2P_DISABLE=1 \
      NCCL_SHM_DISABLE=1 torchrun --nnodes 2 --node_rank i \
      --nproc_per_node 2 --master_addr 127.0.0.1 --master_port 29500 \
      -m mpqe_tpu_torch.tools.multihost_run --parallel halo_ring \
      --mesh 1,1 --out runs/mh_nodes

``--devices`` spreads a process's parts over several cards (JAX's
multi-host shape):

  python -m mpqe_tpu_torch.tools.multihost_run --coordinator 127.0.0.1:29500 \\
      --num_processes 2 --process_id 0 --backend nccl --out runs/mh_nccl
  python -m mpqe_tpu_torch.tools.multihost_run --coordinator 127.0.0.1:29500 \\
      --num_processes 2 --process_id 1 --parallel halo_ring \\
      --device cuda:2 --devices cuda:2,cuda:3 --out runs/mh_2x2

The output is
``<out>/rank<r>.npz`` (``losses``; with ``--params`` each parameter's
change over the run by name, the table whole).

The optimizer is SGD: its step is the gradient times the learning rate,
so a gradient that is reduced twice, or scaled wrongly, shows in the
parameters' changes (Adam's step barely moves when a gradient is
multiplied by a constant).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# the model and batches apart from the sizes the flags set
STRUCTURE = "3-chain_inter"
N_MODES, N_RELS, N_LAYERS, N_NEG = 4, 266, 3, 4
LR = 1.0  # SGD: large enough that the changes stand well above f32 ulps
SEED = 0


def global_batches(steps: int, batch_size: int, spec, n_entities: int):
    """``steps`` global batches (numpy dicts) from ``SEED``."""
    rng = np.random.default_rng(SEED)
    B, K = batch_size, N_NEG
    n_modes, n_rels = N_MODES, N_RELS
    out = []
    for _ in range(steps):
        out.append(dict(
            node_entity=rng.integers(0, n_entities,
                                     (B, spec.n_nodes)).astype(np.int32),
            node_mode=rng.integers(0, n_modes,
                                   (B, spec.n_nodes)).astype(np.int32),
            edge_rel=rng.integers(0, n_rels, (spec.n_edges,)).astype(
                np.int32),
            edge_norm=np.ones((spec.n_edges,), np.float32),
            target=rng.integers(0, n_entities, (B,)).astype(np.int32),
            negatives=rng.integers(0, n_entities, (B, K)).astype(np.int32),
            neg_mask=np.ones((B, K), np.float32),
            # the last eighth of every batch is padding
            query_mask=(np.arange(B) < B - B // 8).astype(np.float32)))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", default=None,
                   help="gloo | nccl (default: nccl on the card, gloo on "
                        "the CPU)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--parallel", default="spmd",
                   choices=("spmd", "halo_ring", "halo_gather"))
    p.add_argument("--mesh", default="2,1",
                   help="each process's mesh (its share of the halo mesh)")
    p.add_argument("--devices", default=None,
                   help="comma-separated devices of this process's parts, "
                        "one per part of --mesh (default: all on "
                        "--device)")
    p.add_argument("--entities", type=int, default=1_000_000)
    p.add_argument("--embed_dim", type=int, default=128)
    p.add_argument("--num_bases", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=512,
                   help="the global batch")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--params", action="store_true",
                   help="also write each parameter's change over the run")
    p.add_argument("--out", required=True, help="output directory")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.parallel import halo_train, ipc
    from mpqe_tpu_torch.parallel import mesh as mesh_lib
    from mpqe_tpu_torch.parallel import multihost, spmd
    from mpqe_tpu_torch.queries import STRUCTURES
    from mpqe_tpu_torch.serve import resolve_device
    from mpqe_tpu_torch.train import loop as loop_mod

    args = parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu raises
    # under NCCL this sets the process's card
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id, backend=args.backend,
                         device=args.device)
    n_proc, rank = multihost.process_count(), multihost.process_index()
    d, m = (int(x) for x in args.mesh.split(","))
    parts = ([mesh_lib._device(x) for x in args.devices.split(",")]
             if args.devices else [mesh_lib._device(args.device)] * (d * m))
    if len(parts) != d * m:
        raise SystemExit(f"--devices lists {len(parts)} devices for a "
                         f"{d}x{m} --mesh")
    device = parts[0]
    halo = args.parallel != "spmd"
    if halo:
        mesh = multihost.global_mesh((d * n_proc, m), parts)
    else:
        mesh = mesh_lib.make_mesh((d, m), devices=parts)
    cfg = mpqe_mod.MPQEConfig(
        n_entities=args.entities, n_modes=N_MODES, n_rels=N_RELS,
        embed_dim=args.embed_dim, n_layers=N_LAYERS,
        num_bases=args.num_bases or None)
    tc = loop_mod.TrainConfig(lr=LR, optimizer="sgd",
                              batch_size=args.batch_size, n_neg=N_NEG)
    gen = torch.Generator(device=device).manual_seed(SEED)
    if halo:
        state = halo_train.init_halo_train_state(gen, cfg, tc, mesh)
        step = halo_train.make_halo_train_step(
            cfg, state.optimizer, mesh, args.parallel.split("_")[1])
    else:
        init_fn, step = spmd.make_spmd_train_step(cfg, tc, mesh)
        state = init_fn(gen)
    init = ({k: v.clone() for k, v in state.model.state_dict().items()}
            if args.params else None)
    spec = STRUCTURES[STRUCTURE]
    per = args.batch_size // n_proc
    lo, hi = rank * per, (rank + 1) * per
    losses = []
    for g in global_batches(args.steps, args.batch_size, spec,
                            cfg.n_entities):
        if halo:  # the whole batch, replicated
            fields = [torch.from_numpy(g[k]).to(device)
                      for k in loop_mod.BATCH_FIELDS]
        else:
            local = {k: (v if k in ("edge_rel", "edge_norm") else v[lo:hi])
                     for k, v in g.items()}
            arrays = multihost.host_local_batch(mesh, local)
            fields = [arrays[k] for k in loop_mod.BATCH_FIELDS]
        losses.append(float(step(state.model, STRUCTURE, *fields)))
    os.makedirs(args.out, exist_ok=True)
    out = {"losses": np.asarray(losses)}
    if init is not None:
        out.update({k: (v - init[k]).float().cpu().numpy()
                    for k, v in state.model.state_dict().items()})
        del init
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **out)
    if device.type == "cuda":
        ipc.close()
    print(f"multihost_run rank={rank}/{n_proc} {args.parallel} "
          f"mesh={dict(mesh.shape)} losses={losses}", flush=True)
    return {"rank": rank, "processes": n_proc, "losses": losses,
            "state": state, "changes": {k: v for k, v in out.items()
                                        if k != "losses"}}


if __name__ == "__main__":
    main()
