"""Import a trained reference (PyTorch) checkpoint into the port's
``MPQE``, and export one (counterpart of
``mpqe_tpu/data/torch_import.py``; the classifier is copied here, not
imported).

A user of the upstream PyTorch MPQE has ``torch.save``d ``state_dict()``
files, the only trained artifacts it produces.  This module maps such a
state dict onto the port's parameters (whose names are the reference's
pytree paths: ``emb.ent``, ``layers.{i}.w_self``, ``readout.w_pre``, ...)
by the reference's rules:

* per R-GCN layer ``i`` (keys matching ``...{convs|layers|rgcns}.{i}.*``,
  PyG ``RGCNConv`` names): ``root [d, d]`` -> ``layers.i.w_self`` (no
  transpose), ``bias [d]`` -> ``layers.i.bias``, ``weight [B, d, d]``
  with a sibling ``comp`` (or a basis config) -> ``layers.i.basis``,
  ``comp [R, B]`` -> ``layers.i.coeff``, ``weight [R, d, d]`` ->
  ``layers.i.w_rel``;
* entity embeddings: one ``[n_entities, d]`` table -> ``emb.ent``, or
  per-mode ``nn.Embedding`` tables matched to modes by name (a dotted
  path component) and placed through ``node_maps`` (row ``j`` of mode
  ``m``'s table is global entity ``node_maps[m][j]``; a dict
  ``{global: local}`` must be a dense permutation);
* variable embeddings: one ``[n_modes, d]`` tensor -> ``emb.var`` (rows
  in sorted-mode-name order) or per-mode ``[d]`` / ``[1, d]`` rows
  matched by name;
* ``key_map`` entries (``{"layers.0.w_self": {"key": ..., "transpose":
  false, "row_offset": 0}}``) come first; ``rel_perm`` permutes
  ``coeff`` / ``w_rel`` rows (``ours[r] = theirs[rel_perm[r]]``).

Anything the classifier cannot place is an error unless
``allow_partial``; then the unplaced leaves keep the port's own
initialisation from the given generator (``init_mpqe``), which differs
from the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
import pickle
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpqe_tpu_torch.models import mpqe as mpqe_mod

_LAYER_RE = re.compile(r"(?:^|\.)(?:convs?|layers|rgcns?)\.(\d+)\.([A-Za-z_]+)$")


def export_mpqe_state_dict(model) -> Dict[str, torch.Tensor]:
    """The port's ``MPQE`` as a reference-shaped state dict (CPU tensors
    in the model's dtype), under the names :func:`import_mpqe_params`
    reads back: ``enc.ent.weight``, ``mode_embeddings.weight``,
    ``rgcn.convs.{i}.{root,bias,weight,comp}`` and ``readout.<leaf>``."""
    def t(p):
        return p.detach().cpu().clone()

    out = {"enc.ent.weight": t(model.emb.ent),
           "mode_embeddings.weight": t(model.emb.var)}
    for i, layer in enumerate(model.layers):
        pre = f"rgcn.convs.{i}."
        out[pre + "root"] = t(layer.w_self)
        out[pre + "bias"] = t(layer.bias)
        if layer.basis is not None:
            out[pre + "weight"] = t(layer.basis)
            out[pre + "comp"] = t(layer.coeff)
        else:
            out[pre + "weight"] = t(layer.w_rel)
    for leaf, p in model.readout.named_parameters():
        out[f"readout.{leaf}"] = t(p)
    return out


def numpy_state_dict(obj) -> Dict[str, np.ndarray]:
    """``{key: ndarray}`` of a state dict of tensors or arrays; bfloat16
    tensors are widened to float32 (exactly)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                v = v.float()
            v = v.numpy()
        out[str(k)] = np.asarray(v)
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint file into ``{key: ndarray}``: a bare
    ``state_dict`` or one under ``"state_dict"``, ``"model_state_dict"``
    or ``"model"``."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # the checkpoint wraps non-tensor objects the weights-only
        # unpickler refuses; retry permissively.  Only this error falls
        # back: a corrupt or truncated file surfaces its own error
        obj = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("state_dict", "model_state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(wrapper), dict):
            obj = obj[wrapper]
            break
    if not isinstance(obj, dict):
        raise ValueError(
            f"{path}: expected a state_dict (dict of tensors), got "
            f"{type(obj).__name__}")
    return numpy_state_dict(obj)


@dataclasses.dataclass
class ShapeInfo:
    """Model shape inferred from the state dict's layer parameters."""

    embed_dim: int
    n_layers: int
    n_rels: int
    num_bases: Optional[int]


def infer_model_shape(sd: Dict[str, np.ndarray]) -> ShapeInfo:
    """Infer (embed_dim, n_layers, n_rels, num_bases) from layer keys."""
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for k, a in sd.items():
        m = _LAYER_RE.search(k)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = a
    if not layers:
        raise ValueError(
            "no R-GCN layer parameters found (keys matching "
            "'{convs|layers|rgcns}.<i>.{root,bias,weight,comp}'); pass an "
            "explicit key map")
    n_layers = max(layers) + 1
    if sorted(layers) != list(range(n_layers)):
        raise ValueError(f"non-contiguous layer indices: {sorted(layers)}")
    first = layers[0]
    if "root" in first:
        d = int(first["root"].shape[0])
    elif "bias" in first:
        d = int(first["bias"].shape[0])
    else:
        d = int(first["weight"].shape[-1])
    if "comp" in first:
        n_rels, num_bases = (int(s) for s in first["comp"].shape)
    elif "weight" in first and first["weight"].ndim == 3:
        n_rels, num_bases = int(first["weight"].shape[0]), None
    else:
        raise ValueError(
            "layer 0 has neither 'comp' nor a 3-D 'weight'; cannot infer "
            "relation vocab")
    return ShapeInfo(embed_dim=d, n_layers=n_layers, n_rels=n_rels,
                     num_bases=num_bases)


@dataclasses.dataclass
class ImportReport:
    mapped: Dict[str, str]  # param path -> source key
    unused_keys: List[str]  # state-dict keys nothing consumed
    missing: List[str]  # required param paths left at init


def _required_paths(model) -> List[str]:
    """The model's leaves in the reference's order (``init_rgcn_layer``
    and ``init_readout`` insertion order)."""
    req = ["emb.ent", "emb.var"]
    for i, layer in enumerate(model.layers):
        leaves = (("w_self", "bias", "basis", "coeff")
                  if layer.basis is not None else ("w_self", "bias", "w_rel"))
        req += [f"layers.{i}.{leaf}" for leaf in leaves]
    req += [f"readout.{leaf}" for leaf, _ in model.readout.named_parameters()]
    return req


def _set_path(params: Dict[str, Any], path: str, arr: np.ndarray) -> None:
    """Assign ``arr`` at ``path`` (e.g. ``layers.0.w_self``), checking the
    leaf exists and has ``arr``'s shape."""
    if path not in params:
        parent = path.rpartition(".")[0]
        here = sorted(p.rpartition(".")[2] for p in params
                      if p.rpartition(".")[0] == parent)
        raise KeyError(
            f"param path {path!r} does not exist in this model config "
            f"(available here: {here})")
    want = tuple(params[path].shape)
    if tuple(arr.shape) != want:
        raise ValueError(
            f"{path}: shape {tuple(arr.shape)} != expected {want}")
    params[path] = arr


def _mode_pattern(mode: str) -> "re.Pattern":
    """Mode name as a dotted path component (``enc.features.<mode>.w``)."""
    return re.compile(r"(?:^|\.)" + re.escape(mode) + r"(?:\.|$)")


def _match_mode_key(keys: Sequence[str], mode: str) -> Optional[str]:
    """The unique key that names ``mode`` as a path component."""
    pat = _mode_pattern(mode)
    hits = [k for k in keys if pat.search(k)]
    if len(hits) == 1:
        return hits[0]
    if len(hits) > 1:
        raise ValueError(
            f"mode {mode!r} matches several state-dict keys: {hits}; "
            "disambiguate with an explicit key map")
    return None


def _global_rows(ids, mode: str) -> np.ndarray:
    """``node_maps[mode]`` as global ids by local row: a list, or a dict
    ``{global_id: local_row}`` whose local rows are a dense 0..n-1
    permutation."""
    if not isinstance(ids, dict):
        return np.asarray(list(ids), dtype=np.int64)
    gl = np.full(len(ids), -1, dtype=np.int64)
    for g, loc in ids.items():
        loc = int(loc)
        if not 0 <= loc < len(ids) or gl[loc] != -1:
            raise ValueError(
                f"node_maps[{mode!r}]: local rows are not a dense 0..n-1 "
                f"permutation (row {loc} duplicate or out of range)")
        gl[loc] = int(g)
    return gl


def import_mpqe_params(
    sd: Dict[str, np.ndarray],
    cfg: mpqe_mod.MPQEConfig,
    gen: torch.Generator,
    *,
    mode_names: Sequence[str],
    node_maps: Optional[Dict[str, Sequence[int]]] = None,
    key_map: Optional[Dict[str, Dict[str, Any]]] = None,
    rel_perm: Optional[np.ndarray] = None,
    allow_partial: bool = False,
    device=None,
) -> Tuple[mpqe_mod.MPQE, ImportReport]:
    """Map a reference state dict (``{key: ndarray}``, e.g. from
    :func:`load_state_dict`) onto ``init_mpqe(gen, cfg)``'s parameters;
    returns the model on ``device`` (through ``convert.py``'s flat
    loader, each leaf in ``cfg.dtype``) and the report.

    ``mode_names`` must be in mode-id order (``kg.mode_names``, the
    sorted-name order ``load_graph_pickle`` assigns).  ``node_maps`` is
    ``graph_data.pkl``'s third element ``{mode: ids}`` (a list of global
    ids, or a dict ``{global_id: local_row}``); it is needed only when
    the state dict holds per-mode entity tables.  ``key_map`` entries
    take precedence over the classifier."""
    from mpqe_tpu_torch.convert import _load_flat

    # the leaves' shapes; the random init is drawn only for what the
    # state dict leaves unplaced
    shapes = mpqe_mod.MPQE(cfg, device="meta")
    params: Dict[str, Any] = dict(shapes.named_parameters())
    drawn: Dict[str, torch.Tensor] = {}

    def init_leaf(path: str) -> torch.Tensor:
        if not drawn:
            init = mpqe_mod.init_mpqe(gen, cfg, device=gen.device)
            drawn.update((n, p.detach()) for n, p in init.named_parameters())
        return drawn[path]

    mapped: Dict[str, str] = {}
    used: set = set()
    d = cfg.embed_dim

    def assign(path: str, arr: np.ndarray, src: str) -> None:
        if path in mapped:
            raise ValueError(
                f"both {mapped[path]!r} and {src!r} map to param {path}")
        if rel_perm is not None and path.split(".")[-1] in ("coeff", "w_rel"):
            arr = arr[np.asarray(rel_perm)]
        _set_path(params, path, arr)
        mapped[path] = src
        used.add(src)

    # 1. the explicit key map wins
    for path, spec in (key_map or {}).items():
        if spec["key"] not in sd:
            raise KeyError(f"key map: {spec['key']!r} not in state dict")
        arr = sd[spec["key"]]
        if spec.get("transpose"):
            arr = arr.T
        off = int(spec.get("row_offset", 0))
        if off:
            arr = arr[off:]
        assign(path, arr, spec["key"])

    # 2. layer parameters by PyG RGCNConv naming
    groups: Dict[int, Dict[str, str]] = {}
    for k in sd:
        if k in used:
            continue
        m = _LAYER_RE.search(k)
        if m:
            groups.setdefault(int(m.group(1)), {})[m.group(2)] = k
    for i, leaves in sorted(groups.items()):
        if i >= cfg.n_layers:
            raise ValueError(
                f"state dict has layer index {i} but cfg.n_layers="
                f"{cfg.n_layers}")
        basis_mode = "comp" in leaves or cfg.num_bases is not None
        for leaf, k in sorted(leaves.items()):
            a = sd[k]
            if leaf == "root":
                tgt = "w_self"
            elif leaf == "bias":
                tgt = "bias"
            elif leaf == "comp":
                tgt = "coeff"
            elif leaf == "weight" and a.ndim == 3:
                tgt = "basis" if basis_mode else "w_rel"
            else:
                continue  # reported as unused
            path = f"layers.{i}.{tgt}"
            if path not in mapped:
                assign(path, a, k)

    # 3. embeddings from the remaining 2-D tensors
    rest = [k for k in sd if k not in used]

    # 3a. variable embeddings
    if "emb.var" not in mapped:
        def names_a_mode(k: str) -> bool:
            # a key that names a specific mode is a per-mode entity
            # table, even if its row count happens to equal n_modes
            return any(_mode_pattern(m).search(k) for m in mode_names)

        var_whole = [k for k in rest
                     if sd[k].shape == (cfg.n_modes, d)
                     and sd[k].shape != (cfg.n_entities, d)
                     and not names_a_mode(k)]
        if len(var_whole) == 1:
            assign("emb.var", sd[var_whole[0]], var_whole[0])
        elif len(var_whole) > 1:
            raise ValueError(
                f"several [n_modes, d] tensors could be emb.var: "
                f"{var_whole}; disambiguate with a key map")
        else:
            # per-mode variable rows ([d] or [1, d]) matched by name
            per_mode = {}
            cand = [k for k in rest if sd[k].shape in ((d,), (1, d))]
            for mi, mode in enumerate(mode_names):
                k = _match_mode_key(cand, mode)
                if k is not None:
                    per_mode[mi] = k
            if len(per_mode) == len(mode_names):
                params["emb.var"] = np.stack(
                    [sd[per_mode[mi]].reshape(d)
                     for mi in range(len(mode_names))])
                for mi in range(len(mode_names)):
                    mapped.setdefault("emb.var", per_mode[mi])
                    used.add(per_mode[mi])

    rest = [k for k in rest if k not in used]

    # 3b. entity embeddings
    if "emb.ent" not in mapped:
        whole = [k for k in rest if sd[k].shape == (cfg.n_entities, d)]
        if len(whole) == 1:
            assign("emb.ent", sd[whole[0]], whole[0])
        elif len(whole) > 1:
            raise ValueError(
                f"several [n_entities, d] tensors could be emb.ent: "
                f"{whole}; disambiguate with a key map")
        else:
            # per-mode tables assembled through node_maps
            cand = [k for k in rest if sd[k].ndim == 2
                    and sd[k].shape[1] == d]
            picks: Dict[str, str] = {}
            for mode in mode_names:
                k = _match_mode_key(cand, mode)
                if k is not None:
                    picks[mode] = k
            if picks:
                if node_maps is None:
                    raise ValueError(
                        "state dict has per-mode entity tables "
                        f"({sorted(picks.values())}) — node_maps from "
                        "graph_data.pkl is required to place their rows "
                        "in the global entity table")
                if sorted(picks) != sorted(mode_names):
                    raise ValueError(
                        "per-mode entity tables found for "
                        f"{sorted(picks)} but modes are "
                        f"{sorted(mode_names)}")
                ent = np.zeros((cfg.n_entities, d), dtype=np.float32)
                claimed = np.zeros(cfg.n_entities, dtype=bool)
                for mode, k in picks.items():
                    gl = _global_rows(node_maps[mode], mode)
                    # globals need the same discipline as local rows: in
                    # range, unique within the mode and not claimed by
                    # another mode, or rows would land on (or overwrite)
                    # the wrong entities
                    if gl.size and (gl.min() < 0
                                    or gl.max() >= cfg.n_entities):
                        raise ValueError(
                            f"node_maps[{mode!r}]: global entity ids "
                            f"outside [0, {cfg.n_entities})")
                    if np.unique(gl).size != gl.size:
                        raise ValueError(
                            f"node_maps[{mode!r}]: duplicate global ids")
                    if claimed[gl].any():
                        raise ValueError(
                            f"node_maps[{mode!r}]: global ids already "
                            "claimed by another mode")
                    claimed[gl] = True
                    a = sd[k]
                    if a.shape[0] != len(gl):
                        raise ValueError(
                            f"{k}: {a.shape[0]} rows but mode {mode!r} "
                            f"has {len(gl)} entities; if the table has "
                            "a padding row, set row_offset in a key map "
                            "entry for emb.ent")
                    ent[gl] = a
                    used.add(k)
                    mapped.setdefault("emb.ent", k)
                if not claimed.all():
                    # rows no mode claims keep the init
                    rest_rows = ~claimed
                    ent[rest_rows] = init_leaf("emb.ent").float().cpu() \
                        .numpy()[rest_rows]
                params["emb.ent"] = ent

    missing = [p for p in _required_paths(shapes) if p not in mapped]
    unused = [k for k in sd if k not in used]
    if missing and not allow_partial:
        raise ValueError(
            "state dict did not cover these params (pass a key map, or "
            f"allow_partial=True to keep them at random init): {missing}; "
            f"unconsumed state-dict keys: {unused}")
    for path in missing:
        params[path] = init_leaf(path)
    model = _load_flat(params, cfg, device)
    return model, ImportReport(mapped=mapped, unused_keys=unused,
                               missing=missing)
