#!/usr/bin/env python3
"""The forward loss of the train step by piece on the card (counterpart
of ``tools/loss_breakdown.py``), at the flagship shape of
``step_breakdown``:

  encode        the query vectors alone (``encode_dense``)
  gather        the entity-row gather alone (anchors, target and
                negatives in one ``ops/embed.py embedding_lookup``)
  enc_gather    encode and gather, no scoring
  pos_score     encode and the positive cosine scores
  full_loss     the production ``dense_batch_loss``

Each is a forward without gradients, timed by ``utils/profiling.py
loop_time`` with its result threaded into the next iteration's edge
norms, and profiled on the card.  Prints one JSON line per phase,
``{"phase", "ms"}`` (the reference's keys) with ``device_ms``,
``busy_share`` and ``kernels``.  Runs on the card unless ``--device
cpu``.

  python -m mpqe_tpu_torch.tools.loss_breakdown
"""

from __future__ import annotations

import argparse
import json

import torch

from mpqe_tpu_torch.tools.probe_common import (dense_batch, device_fields,
                                               device_of, log, timed)

D = 128
N_ENTITIES = 1_000_000
N_RELS = 266
STRUCTURE = "3-chain_inter"
B = 131_072
N_NEG = 4


def phases(model, cfg, ne, nm, er, tgt, neg, nmask, qmask) -> dict:
    """``{phase: fn(edge_norm) -> scalar}``, the reference's five."""
    from mpqe_tpu_torch.models import mpqe as mpqe_mod
    from mpqe_tpu_torch.ops import embed as embed_ops

    a_slots = list(mpqe_mod.anchor_gather_slots(cfg, STRUCTURE))
    idx_all = torch.cat([ne[:, a_slots], tgt[:, None], neg], dim=1)
    ent = model.emb.ent

    def encode(en):
        return mpqe_mod.encode_dense(model, cfg, STRUCTURE, ne, nm, er, en)

    def gather():
        return embed_ops.embedding_lookup(ent, idx_all)

    return {
        "encode": lambda en: torch.sum(encode(en)) * 1e-9,
        "gather": lambda en: torch.sum(gather()) * 1e-9,
        "enc_gather": lambda en: (torch.sum(encode(en))
                                  + torch.sum(gather())) * 1e-9,
        "pos_score": lambda en: torch.sum(mpqe_mod.score(
            cfg, encode(en), ent[tgt.long()])) * 1e-9,
        "full_loss": lambda en: mpqe_mod.dense_batch_loss(
            model, cfg, STRUCTURE, ne, nm, er, en, tgt, neg, nmask, qmask),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpqe_tpu_torch.tools."
                                 "loss_breakdown")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the card unless told otherwise")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from mpqe_tpu_torch.models import mpqe as mpqe_mod

    cfg = mpqe_mod.MPQEConfig(
        n_entities=N_ENTITIES, n_modes=4, n_rels=N_RELS, embed_dim=D,
        n_layers=3, num_bases=16, readout="tgt")
    model = mpqe_mod.init_mpqe(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
    ne, nm, er, en0, tgt, neg, nmask, qmask = dense_batch(
        N_ENTITIES, 4, N_RELS, STRUCTURE, B, N_NEG, dev)
    log(f"device={device_fields(dev)} B={B}")
    for name, fn in phases(model, cfg, ne, nm, er, tgt, neg, nmask,
                           qmask).items():
        def loop(n, fn=fn):
            en, acc = en0, torch.zeros((), device=dev)
            with torch.no_grad():
                for _ in range(n):
                    out = fn(en)
                    en = en + out * 1e-30
                    acc = acc + out
            return acc

        log(f"{name}...")
        print(json.dumps({"phase": name, **timed(loop, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
