#!/usr/bin/env python3
"""Export an MPQE run dir of the port as a reference-shaped torch
state_dict file (counterpart of ``tools/export_torch_checkpoint.py``)::

    python -m mpqe_tpu_torch.tools.export_torch_checkpoint \\
        --run_dir runs/myrun --out model.pt

Keys follow the PyG ``RGCNConv`` naming the importer reads
(``rgcn.convs.{i}.{root,bias,weight,comp}``, ``enc.ent.weight``,
``mode_embeddings.weight``, ``readout.<leaf>``), in the model's dtype;
``python -m mpqe_tpu_torch.tools.import_torch_checkpoint`` and the JAX
package's importer read the file back bit for bit.  MPQE run dirs only.
``--device`` is the card unless told otherwise (no card and no
``--device cpu``: it raises).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--ckpt", default=None,
                   help="defaults to latest in run_dir/ckpt")
    p.add_argument("--out", required=True, help="output .pt file")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless told otherwise")
    args = p.parse_args(argv)

    import torch

    from mpqe_tpu_torch import evaluate as eval_cli
    from mpqe_tpu_torch.data.torch_import import export_mpqe_state_dict
    from mpqe_tpu_torch.serve import config_from_json, resolve_device

    device = resolve_device(args.device)
    with open(os.path.join(args.run_dir, "model_config.json")) as f:
        mc = json.load(f)
    if "readout" not in mc:
        raise SystemExit("GQE run dirs are not exportable (MPQE only)")
    _, step, model = eval_cli.restore_model(
        args.run_dir, config_from_json(mc), args.ckpt, device)
    sd = export_mpqe_state_dict(model)
    torch.save(sd, args.out)
    print(json.dumps({"out": args.out, "keys": len(sd), "step": step}),
          flush=True)


if __name__ == "__main__":
    main()
