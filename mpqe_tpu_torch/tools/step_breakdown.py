#!/usr/bin/env python3
"""The train step by phase on the card (counterpart of
``tools/step_breakdown.py``): the forward loss, the loss and its
gradient, the optimizer update alone and the whole step, at the
flagship shape (B = 131,072 ``3-chain_inter`` queries, 4 negatives,
10^6 entities, d = 128, 3 layers, 16 bases; random weights from seed 0),
each timed by ``utils/profiling.py loop_time`` with the device ms by
kernel beside it.

``--kernel dense`` decomposes ``models/mpqe.py dense_batch_loss``;
``--kernel fused_fwd`` its K1 forward with the K2 backward
(``dense_batch_loss_kernel_fused_fwd(backward="pallas")``).  The update
is ``train/loop.py OptaxAdam.step`` (optax's formulas) at lr 0.01.  The
loops' data dependency runs through the edge norms (the forward) and
through the parameters (the gradient: ``p += g * 1e-20``, as the
reference).  ``--adam_probe`` adds the entity table's Adam update alone,
dense (three full-table streams) and on ``R_TOUCHED`` distinct touched
rows (gather, update, scatter back).

Prints one JSON line per phase, ``{"phase", "ms"}`` (the reference's
keys), with ``device_ms``, ``busy_share`` and ``kernels`` from the
card's profile.  Runs on the card unless ``--device cpu``.

  python -m mpqe_tpu_torch.tools.step_breakdown [--kernel fused_fwd]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mpqe_tpu_torch.tools.probe_common import (dense_batch, device_fields,
                                               device_of, log, timed)

D = 128
N_ENTITIES = 1_000_000
N_RELS = 266
STRUCTURE = "3-chain_inter"
B = 131_072
N_NEG = 4
# distinct rows a flagship batch touches: B * (2 anchors + target + 4
# negatives) = 917,504 draws from 10^6 give about 600k
R_TOUCHED = 655_360


def report(name: str, rec: dict) -> None:
    print(json.dumps({"phase": name, **rec}), flush=True)


def loss_for(kernel: str, cfg, ne, nm, er, tgt, neg, nmask, qmask):
    """``loss(model, edge_norm)`` of the path ``--kernel`` decomposes."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    if kernel == "fused_fwd":
        def loss_of(m, en):
            return mpqe_mod.dense_batch_loss_kernel_fused_fwd(
                m, cfg, STRUCTURE, ne, nm, er, en, tgt, neg, nmask, qmask,
                backward="pallas")
    else:
        def loss_of(m, en):
            return mpqe_mod.dense_batch_loss(
                m, cfg, STRUCTURE, ne, nm, er, en, tgt, neg, nmask, qmask)
    return loss_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "step_breakdown")
    ap.add_argument("--kernel", default="dense",
                    choices=["dense", "fused_fwd"],
                    help="loss path to decompose: dense_batch_loss, or K1 "
                         "forward with the K2 backward")
    ap.add_argument("--adam_probe", action="store_true",
                    help="time the entity table's Adam update dense "
                         "(full-table streams) and touched-row "
                         "(gather, update, scatter of R_TOUCHED rows)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.bench import _step_loop
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.train import loop as loop_mod

    cfg = mpqe_mod.MPQEConfig(
        n_entities=N_ENTITIES, n_modes=4, n_rels=N_RELS, embed_dim=D,
        n_layers=3, num_bases=16, readout="tgt")
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    ne, nm, er, en0, tgt, neg, nmask, qmask = dense_batch(
        N_ENTITIES, 4, N_RELS, STRUCTURE, B, N_NEG, dev)
    log(f"device={device_fields(dev)} kernel={args.kernel} B={B}")

    loss_of = loss_for(args.kernel, cfg, ne, nm, er, tgt, neg, nmask, qmask)
    params = list(model.parameters())
    optimizer = loop_mod.make_optimizer(loop_mod.TrainConfig(lr=0.01),
                                        params)

    def fwd_loop(n):
        en, acc = en0, torch.zeros((), device=dev)
        with torch.no_grad():
            for _ in range(n):
                loss = loss_of(model, en)
                en = en + loss * 1e-20
                acc = acc + loss
        return acc

    report("forward_loss", timed(fwd_loop, dev))

    def grad_loop(n):
        acc = torch.zeros((), device=dev)
        for _ in range(n):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_of(model, en0)
            loss.backward()
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.add_(p.grad, alpha=1e-20)
            acc = acc + loss.detach() * 1e-9
        return acc

    report("loss_plus_grad", timed(grad_loop, dev))

    # the update alone, on one fixed gradient
    optimizer.zero_grad(set_to_none=True)
    loss_of(model, en0).backward()

    def opt_loop(n):
        for _ in range(n):
            optimizer.step()
        return model.emb.ent[0, 0].detach()

    report("adam_update", timed(opt_loop, dev))
    report("full_step", timed(_step_loop(model, optimizer,
                                         lambda m: loss_of(m, en0)), dev))

    if args.adam_probe:
        adam_probe(model, dev)
    return 0


def adam_probe(model, dev) -> None:
    """The entity table's Adam moments and update, dense over the whole
    table and on ``R_TOUCHED`` distinct rows."""
    rng = np.random.default_rng(0)
    ent = model.emb.ent.detach()
    g = torch.randn(ent.shape, generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)

    def dense_loop(n):
        p, m, v = ent.clone(), torch.zeros_like(ent), torch.zeros_like(ent)
        for _ in range(n):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(0.01 * m / (torch.sqrt(v) + 1e-8))
        return p[0, 0] + m[0, 0] + v[0, 0]

    report("adam_dense_ent_table", timed(dense_loop, dev))

    idx = torch.from_numpy(rng.choice(ent.shape[0], size=R_TOUCHED,
                                      replace=False).astype(np.int64)).to(dev)
    gr = torch.from_numpy(rng.normal(size=(R_TOUCHED, ent.shape[1])
                                     ).astype(np.float32)).to(dev)

    def touched_loop(n):
        p, m, v = ent.clone(), torch.zeros_like(ent), torch.zeros_like(ent)
        for _ in range(n):
            mr = 0.9 * m[idx] + 0.1 * gr
            vr = 0.999 * v[idx] + 0.001 * (gr * gr)
            pr = p[idx] - 0.01 * mr / (torch.sqrt(vr) + 1e-8)
            p.index_copy_(0, idx, pr)
            m.index_copy_(0, idx, mr)
            v.index_copy_(0, idx, vr)
        return p[0, 0] + m[0, 0] + v[0, 0]

    report(f"adam_touched_rows_{R_TOUCHED // 1000}k",
           timed(touched_loop, dev))


if __name__ == "__main__":
    raise SystemExit(main())
