"""Carry MPQE weights across from the JAX package.

Two layouts reach the port:

* the JAX parameter pytree as numpy arrays (``{"emb": {...}, "layers":
  [...], "readout": {...}}``, e.g. ``jax.tree.map(np.asarray, params)``):
  :func:`model_from_numpy` / :func:`model_to_numpy`;
* one R-GCN layer's dict (``basis``/``coeff`` or ``w_rel``, ``w_self``,
  ``bias``), as the reference's ``init_rgcn_layer`` makes it:
  :func:`layer_from_numpy`;
* the reference-shaped torch state dict that ``mpqe_tpu``'s
  ``export_mpqe_state_dict`` and ``tools/export_torch_checkpoint.py``
  write (``enc.ent.weight``, ``mode_embeddings.weight``,
  ``rgcn.convs.{i}.{root,bias,weight,comp}``, ``readout.*``):
  :func:`model_from_state_dict`.  The key names are copied here, not
  imported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mpqe_tpu_torch.models.mpqe import MPQE, MPQEConfig
from mpqe_tpu_torch.ops.rgcn import RGCNLayer


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def model_from_numpy(tree: Mapping[str, Any], cfg: MPQEConfig,
                     device=None) -> MPQE:
    """The port's ``MPQE`` holding the arrays of a JAX parameter pytree.
    Every leaf of the model must be present with its exact shape."""
    flat: Dict[str, Any] = {
        "emb.ent": tree["emb"]["ent"],
        "emb.var": tree["emb"]["var"],
    }
    for i, layer in enumerate(tree["layers"]):
        for leaf, arr in layer.items():
            flat[f"layers.{i}.{leaf}"] = arr
    for leaf, arr in tree.get("readout", {}).items():
        flat[f"readout.{leaf}"] = arr
    return _load_flat(flat, cfg, device)


def layer_from_numpy(params: Mapping[str, Any], device=None) -> RGCNLayer:
    """The port's ``RGCNLayer`` holding one JAX layer dict's arrays (f32)
    on ``device``; its widths, relation count and bases are read from
    the arrays."""
    w_self = _to_numpy(params["w_self"])
    d_in, d_out = w_self.shape
    if "basis" in params:
        coeff = _to_numpy(params["coeff"])
        n_rels, num_bases = coeff.shape
        leaves = ("w_self", "bias", "basis", "coeff")
    else:
        n_rels, num_bases = _to_numpy(params["w_rel"]).shape[0], None
        leaves = ("w_self", "bias", "w_rel")
    layer = RGCNLayer(d_in, d_out, n_rels, num_bases, device=device)
    with torch.no_grad():
        for leaf in leaves:
            a = torch.tensor(_to_numpy(params[leaf]), dtype=torch.float32)
            p = getattr(layer, leaf)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{leaf}: shape {tuple(a.shape)} != "
                                 f"expected {tuple(p.shape)}")
            p.copy_(a)
    return layer


def model_to_numpy(model: MPQE) -> Dict[str, Any]:
    """Inverse of :func:`model_from_numpy`: the JAX pytree layout."""
    def leaves(mod):
        return {k: _to_numpy(v) for k, v in mod.named_parameters()}

    return {
        "emb": leaves(model.emb),
        "layers": [leaves(layer) for layer in model.layers],
        "readout": leaves(model.readout),
    }


def model_from_state_dict(sd: Mapping[str, Any], cfg: MPQEConfig,
                          device=None) -> MPQE:
    """The port's ``MPQE`` from a reference-shaped state dict (arrays or
    tensors).  Layer ``weight`` is ``basis`` when ``comp`` is present,
    else ``w_rel``."""
    flat: Dict[str, Any] = {
        "emb.ent": sd["enc.ent.weight"],
        "emb.var": sd["mode_embeddings.weight"],
    }
    for i in range(cfg.n_layers):
        pre = f"rgcn.convs.{i}."
        flat[f"layers.{i}.w_self"] = sd[pre + "root"]
        flat[f"layers.{i}.bias"] = sd[pre + "bias"]
        if pre + "comp" in sd:
            flat[f"layers.{i}.basis"] = sd[pre + "weight"]
            flat[f"layers.{i}.coeff"] = sd[pre + "comp"]
        else:
            flat[f"layers.{i}.w_rel"] = sd[pre + "weight"]
    for k, v in sd.items():
        if k.startswith("readout."):
            flat[k] = v
    return _load_flat(flat, cfg, device)


def _load_flat(flat: Dict[str, Any], cfg: MPQEConfig, device) -> MPQE:
    model = MPQE(cfg, device=device)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(
            f"parameters do not match the model config: missing {missing}, "
            f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            a = torch.tensor(_to_numpy(flat[name]), dtype=torch.float32)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"expected {tuple(p.shape)}")
            p.copy_(a)
    return model
