"""Carry MPQE and GQE weights across from the JAX package.

These layouts reach the port:

* the JAX parameter pytree as numpy arrays (``{"emb": {...}, "layers":
  [...], "readout": {...}}``, e.g. ``jax.tree.map(np.asarray, params)``):
  :func:`model_from_numpy` / :func:`model_to_numpy`;
* one R-GCN layer's dict (``basis``/``coeff`` or ``w_rel``, ``w_self``,
  ``bias``), as the reference's ``init_rgcn_layer`` makes it:
  :func:`layer_from_numpy`;
* a reference-shaped torch state dict (``enc.ent.weight``,
  ``mode_embeddings.weight``, ``rgcn.convs.{i}.{root,bias,weight,comp}``,
  ``readout.*``, or the upstream PyTorch MPQE's names):
  :func:`model_from_state_dict`, a caller of
  ``data/torch_import.py``'s classifier;
* the JAX GQE pytree as numpy arrays (``{"emb": {...}, "rel_mat": ...,
  "nbr": {...}}``): :func:`gqe_from_numpy` / :func:`gqe_to_numpy`.

Leaves are float32 or bfloat16.  A JAX bf16 array reaches numpy as an
array whose ``dtype.name`` is ``"bfloat16"`` (an ``ml_dtypes`` type,
which this package does not import): it is carried across bit for bit
through its ``uint16`` view.  The other way, a bf16 leaf leaves the port
as that ``uint16`` view (``np.ndarray.view(jnp.bfloat16)`` restores the
JAX array's bits).  Every leaf is loaded in the model's dtype
(``cfg.dtype``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mpqe_tpu_torch.models.gqe import GQE, GQEConfig
from mpqe_tpu_torch.models.mpqe import MPQE, MPQEConfig
from mpqe_tpu_torch.ops.rgcn import RGCNLayer


def _to_numpy(a) -> np.ndarray:
    """A tensor or array as numpy; a bf16 tensor as its ``uint16``
    view (numpy has no bfloat16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    return np.asarray(a)


def _to_tensor(a) -> torch.Tensor:
    """A leaf from the JAX package or the port as a CPU tensor: a numpy
    bfloat16 array (``dtype.name == "bfloat16"``) becomes a bf16 tensor
    with the same bits; anything else keeps its values."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


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
    """The port's ``RGCNLayer`` holding one JAX layer dict's arrays on
    ``device``, in the arrays' dtype (float32 or bfloat16); its widths,
    relation count and bases are read from the arrays."""
    w_self = _to_numpy(params["w_self"])
    d_in, d_out = w_self.shape
    if "basis" in params:
        coeff = _to_numpy(params["coeff"])
        n_rels, num_bases = coeff.shape
        leaves = ("w_self", "bias", "basis", "coeff")
    else:
        n_rels, num_bases = _to_numpy(params["w_rel"]).shape[0], None
        leaves = ("w_self", "bias", "w_rel")
    dtype = _to_tensor(params["w_self"]).dtype
    layer = RGCNLayer(d_in, d_out, n_rels, num_bases, device=device).to(dtype)
    with torch.no_grad():
        for leaf in leaves:
            a = _to_tensor(params[leaf])
            p = getattr(layer, leaf)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{leaf}: shape {tuple(a.shape)} != "
                                 f"expected {tuple(p.shape)}")
            p.copy_(a)
    return layer


def model_to_numpy(model: MPQE) -> Dict[str, Any]:
    """Inverse of :func:`model_from_numpy`: the JAX pytree layout (bf16
    leaves as ``uint16`` views)."""
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
    tensors): ``data/torch_import.py import_mpqe_params`` with every leaf
    required.  The names ``export_mpqe_state_dict`` writes for the tables
    and the readout (``enc.ent.weight``, ``mode_embeddings.weight``,
    ``readout.<leaf>``) are placed by name through the key map; the rest
    goes through the classifier, modes named ``mode0``, ``mode1``, ...
    (the synthetic KGs' names)."""
    from mpqe_tpu_torch.data import torch_import

    key_map = {k: {"key": k} for k in sd if k.startswith("readout.")}
    for path, key in (("emb.ent", "enc.ent.weight"),
                      ("emb.var", "mode_embeddings.weight")):
        if key in sd:
            key_map[path] = {"key": key}
    model, _ = torch_import.import_mpqe_params(
        torch_import.numpy_state_dict(sd), cfg, torch.Generator(),
        mode_names=tuple(f"mode{i}" for i in range(cfg.n_modes)),
        key_map=key_map, device=device)
    return model


def gqe_from_numpy(tree: Mapping[str, Any], cfg: GQEConfig,
                   device=None) -> GQE:
    """The port's ``GQE`` holding the arrays of a JAX GQE parameter pytree
    (nested dicts flattened with dots).  Every leaf of the model must be
    present with its exact shape."""
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            for leaf, arr in val.items():
                flat[f"{key}.{leaf}"] = arr
        else:
            flat[key] = val
    return _load_flat(flat, cfg, device, GQE)


def gqe_to_numpy(model: GQE) -> Dict[str, Any]:
    """Inverse of :func:`gqe_from_numpy`: the JAX pytree layout."""
    out: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        head, _, leaf = name.partition(".")
        if leaf:
            out.setdefault(head, {})[leaf] = _to_numpy(p)
        else:
            out[head] = _to_numpy(p)
    return out


def _load_flat(flat: Dict[str, Any], cfg, device, cls=MPQE):
    model = cls(cfg, device=device)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(
            f"parameters do not match the model config: missing {missing}, "
            f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            a = _to_tensor(flat[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"expected {tuple(p.shape)}")
            p.copy_(a)
    return model
