"""Debug and numerical-safety utilities (counterpart of
``mpqe_tpu/utils/debug.py``).

* :func:`checked`: the counterpart of ``checkify(float_checks |
  index_checks)`` + ``jit``.  Every aten op of the wrapped call passes
  through a ``TorchDispatchMode`` that raises ``FloatingPointError``
  naming the op when an op of checkify's NaN list (arithmetic,
  reductions, products, transcendental functions; not copies, gathers,
  ``where``, ``max``/``min``) gives a NaN, or a division meets a zero
  divisor; and ``IndexError`` naming the op when an index op (advanced
  indexing, ``index_select``, ``gather``, ``embedding``, ``index_add``,
  ``index_put``, ``scatter*``, ...) gets an index outside its dimension,
  before the op runs (on the card an out-of-range index would otherwise
  be a device-side assert).  Every checked op synchronises with the
  card: for debugging only.
* :func:`assert_all_finite`: host-side guard over dicts, lists, tuples,
  tensors, numpy arrays and an ``nn.Module``'s state dict, its message
  naming the leaf as ``jax.tree_util.keystr`` does.
* :func:`seed_everything`: pins ``random``, numpy and
  ``torch.manual_seed``; returns a ``torch.Generator`` seeded alike (the
  counterpart of the reference's root ``PRNGKey``).

The reference's ``pallas_interpret`` (every Pallas kernel through the
interpreter) has no counterpart: the port's kernels are CUDA, and on
the CPU every wrapper already runs its plain PyTorch version.
"""

from __future__ import annotations

import functools
import random
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# aten ops checked for NaN outputs: the counterparts of the primitives
# in checkify's ``nan_primitives`` (add, sub, mul, div, dot_general,
# reduce_sum, exp, log, sqrt, pow, ...)
_NAN_OPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "true_divide", "floor_divide",
    "remainder", "fmod", "addmm", "addmv", "addbmm", "baddbmm", "mm", "bmm",
    "mv", "dot", "vdot", "matmul", "linear", "_addmm_activation", "sum",
    "mean", "prod", "nansum", "cumsum", "cumprod", "logcumsumexp",
    "logsumexp", "_softmax", "_log_softmax", "exp", "exp2", "expm1", "log",
    "log1p", "log2", "log10", "sqrt", "rsqrt", "pow", "square", "sin",
    "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "sigmoid", "erf", "erfc", "erfinv",
    "lgamma", "digamma", "reciprocal", "addcmul", "addcdiv", "lerp",
    "linalg_vector_norm", "norm", "var", "std", "var_mean", "std_mean",
    "constant_pad_nd", "convolution",
))
_DIV_OPS = frozenset(("div", "true_divide", "floor_divide"))
# index ops, by where their index and its dimension are: advanced
# indexing (a list of index tensors, one per leading dim; negative
# indices wrap as in Python), ``(input, dim, index, ...)`` ops and
# ``embedding(weight, indices)``
_ADVANCED_INDEX_OPS = frozenset((
    "index", "_unsafe_index", "index_put", "_index_put_impl",
    "_unsafe_index_put"))
_DIM_INDEX_OPS = frozenset((
    "index_select", "gather", "scatter", "scatter_add", "scatter_reduce",
    "index_add", "index_copy", "index_fill", "index_reduce"))


def _op_name(func) -> str:
    """The aten base name: ``add`` for ``aten.add_.Tensor``."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _indices(name: str, args) -> list:
    """``(index tensor, size of its dimension, negatives wrap)`` of an
    index op's arguments; empty for any other op."""
    if name in _ADVANCED_INDEX_OPS:
        return [(ix, args[0].shape[d], True)
                for d, ix in enumerate(args[1]) if ix is not None]
    if name in _DIM_INDEX_OPS:
        return [(args[2], args[0].shape[args[1]], False)]
    if name == "embedding":
        return [(args[1], args[0].shape[0], False)]
    return []


def _check_indices(func, name: str, args) -> None:
    for ix, n, wraps in _indices(name, args):
        if not isinstance(ix, torch.Tensor) or ix.numel() == 0 or \
                ix.dtype in (torch.bool, torch.uint8):
            continue
        lo, hi = int(ix.min()), int(ix.max())
        if hi >= n or lo < (-n if wraps else 0):
            bad = hi if hi >= n else lo
            raise IndexError(
                f"out-of-bounds indexing in {func}: index {bad} is out of "
                f"bounds for a dimension of size {n}")


class _CheckMode(TorchDispatchMode):
    """Runs each aten op with checkify's float and index checks."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_name(func)
        _check_indices(func, name, args)
        if name in _DIV_OPS and len(args) > 1:
            d = args[1]
            zero = (bool((d == 0).any()) if isinstance(d, torch.Tensor)
                    else d == 0)
            if zero:
                raise FloatingPointError(f"division by zero in {func}")
        out = func(*args, **kwargs)
        if name in _NAN_OPS:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"nan generated by {func}")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` wrapped so that every op it runs (its backward too, when it
    calls ``backward``) is checked: ``FloatingPointError`` on a NaN or a
    division by zero, ``IndexError`` on an out-of-range index, each
    naming the aten op."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with _CheckMode():
            return fn(*args, **kw)

    return wrapper


def _leaves(tree, path: str):
    """``(keystr path, leaf)`` pairs in ``jax.tree_util``'s order: dict
    keys sorted, ``['k']`` for a key and ``[i]`` for a sequence index."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_all_finite(tree: Any, name: str = "pytree") -> None:
    """``FloatingPointError`` naming the first floating leaf of ``tree``
    that holds a NaN or an infinity, and how many."""
    for path, leaf in _leaves(tree, ""):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad = int((~torch.isfinite(leaf)).sum())
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind != "f":
                continue
            bad = int(np.count_nonzero(~np.isfinite(arr)))
        if bad:
            raise FloatingPointError(f"{name}{path}: {bad} non-finite values")


def seed_everything(seed: int) -> torch.Generator:
    """Pin the host RNGs and torch's default generators; return a
    ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
