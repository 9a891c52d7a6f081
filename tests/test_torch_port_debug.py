"""The port's ``utils/debug.py`` against ``mpqe_tpu/utils/debug.py`` on the
CPU: ``checked`` raises in exactly the cases where the reference's
checkify-wrapped function raises (the port's as ``FloatingPointError``
or ``IndexError`` naming the aten op), ``assert_all_finite`` names the
same leaf path, and ``seed_everything`` pins the host RNGs alike."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.utils import debug as jdebug
from mpqe_tpu_torch.convert import model_from_numpy
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.utils import debug as tdebug

D = 16
X = np.asarray([1.0, 1.0], np.float32)


def _batch(seed=0, B=8, n_ent=40):
    """A 2-inter batch: node ids, modes, relations, norms, target,
    negatives and masks, from numpy."""
    rng = np.random.default_rng(seed)
    ne = rng.integers(0, n_ent, size=(B, 3)).astype(np.int32)
    nm = rng.integers(0, 3, size=(B, 3)).astype(np.int32)
    er = np.asarray([1, 4], np.int32)
    en = np.ones(2, np.float32)
    tgt = rng.integers(0, n_ent, size=B).astype(np.int32)
    negs = rng.integers(0, n_ent, size=(B, 3)).astype(np.int32)
    return ne, nm, er, en, tgt, negs, np.ones((B, 3), np.float32), \
        np.ones(B, np.float32)


def _train_loss_pair(nan_row=None):
    """(JAX loss and gradient fn, port fn running the same loss and its
    backward) on one batch and the same parameters."""
    kw = dict(n_entities=40, n_modes=3, n_rels=8, embed_dim=D, n_layers=2,
              num_bases=4, readout="tgt")
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(0), jcfg)
    arrays = _batch()
    if nan_row is not None:
        # an anchor entity of the batch: its row is gathered
        params["emb"]["ent"] = params["emb"]["ent"].at[
            int(arrays[0][0, 0])].set(jnp.nan)
    model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")

    def jfn(_):
        def loss(p):
            return jm.dense_batch_loss(p, jcfg, "2-inter",
                                       *map(jnp.asarray, arrays))
        return jax.value_and_grad(loss)(params)[0]

    def tfn(_):
        loss = tm.dense_batch_loss(model, tcfg, "2-inter",
                                   *map(torch.as_tensor, arrays))
        loss.backward()
        return loss.detach()

    return jfn, tfn


def _case(name):
    if name == "train_loss":
        return _train_loss_pair()
    if name == "train_loss_nan_entity_row":
        return _train_loss_pair(nan_row=True)
    return {
        "log2": (lambda x: jnp.log(2 * x), lambda x: torch.log(2 * x)),
        "log_minus1": (lambda x: jnp.log(-x), lambda x: torch.log(-x)),
        "zero_over_zero": (lambda x: (x - x) / (x - x),
                           lambda x: (x - x) / (x - x)),
        "one_over_zero": (lambda x: x / (x - x), lambda x: x / (x - x)),
        "exp1000": (lambda x: jnp.exp(1000 * x),
                    lambda x: torch.exp(1000 * x)),
        "gather_past_end": (
            lambda x: jnp.arange(4.0)[jnp.asarray([1, 5])] * x[0],
            lambda x: torch.arange(4.0)[torch.tensor([1, 5])] * x[0]),
    }[name]


@pytest.mark.parametrize("name", [
    "log2", "log_minus1", "zero_over_zero", "one_over_zero", "exp1000",
    "gather_past_end", "train_loss", "train_loss_nan_entity_row"])
def test_checked_raises_where_checkify_does(name):
    jfn, tfn = _case(name)
    try:
        jdebug.checked(jfn)(jnp.asarray(X))
        j_raised = False
    except Exception:  # checkify's JaxRuntimeError
        j_raised = True
    try:
        out = tdebug.checked(tfn)(torch.as_tensor(X))
        t_raised = None
    except (FloatingPointError, IndexError) as e:
        t_raised = e
    assert (t_raised is not None) == j_raised, (name, t_raised)
    if t_raised is not None:
        assert "aten." in str(t_raised)  # names the op
    else:
        # unchanged result: the same call outside the mode
        want = tfn(torch.as_tensor(X))
        assert torch.equal(out, want)


def test_checked_names_the_op_and_kind():
    with pytest.raises(FloatingPointError, match=r"nan generated by aten\.log"):
        tdebug.checked(torch.log)(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError,
                       match=r"division by zero in aten\.div"):
        tdebug.checked(lambda x: x / 0.0)(torch.ones(2))
    with pytest.raises(IndexError, match="aten.index_select"):
        tdebug.checked(torch.index_select)(torch.ones(4), 0,
                                           torch.tensor([0, 4]))
    with pytest.raises(IndexError, match="aten.embedding"):
        tdebug.checked(torch.nn.functional.embedding)(
            torch.tensor([[3, -1]]), torch.ones(4, 2))
    # negative advanced indices wrap, as in Python: in range
    out = tdebug.checked(lambda x: x[torch.tensor([-1, -4])])(
        torch.arange(4.0))
    assert out.tolist() == [3.0, 0.0]


def test_assert_all_finite_names_the_leaf_as_jax_does():
    bad = np.asarray([1.0, np.nan, np.inf], np.float32)
    tree = {"b": [np.ones(2, np.float32), {"x": bad}],
            "a": np.zeros(3, np.int32), "c": (np.ones(1), None)}
    msgs = []
    for fn, conv in ((jdebug.assert_all_finite, lambda t: t),
                     (tdebug.assert_all_finite,
                      lambda t: {"b": [torch.ones(2),
                                       {"x": torch.from_numpy(bad)}],
                                 "a": np.zeros(3, np.int32),
                                 "c": (np.ones(1), None)})):
        with pytest.raises(FloatingPointError) as e:
            fn(conv(tree), "params")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "params['b'][1]['x']: 2 non-finite values"
    jdebug.assert_all_finite({"a": np.ones(2)})
    tdebug.assert_all_finite({"a": np.ones(2)})
    model = tm.MPQE(tm.MPQEConfig(n_entities=5, n_modes=2, n_rels=4,
                                  embed_dim=4, n_layers=1), device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(0.5)
        model.emb.ent[2, 1] = float("inf")
    with pytest.raises(FloatingPointError,
                       match=r"model\['emb.ent'\]: 1 non-finite values"):
        tdebug.assert_all_finite(model, "model")


def test_seed_everything_pins_host_rngs_as_jax_does():
    key = jdebug.seed_everything(7)
    want = (np.random.rand(3), random.random())
    gen = tdebug.seed_everything(7)
    got = (np.random.rand(3), random.random())
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert np.asarray(key).tolist() == [0, 7]
    assert torch.equal(torch.randn(4, generator=gen),
                       torch.randn(4, generator=torch.Generator()
                                   .manual_seed(7)))
    tdebug.seed_everything(7)
    a = torch.randn(3)
    tdebug.seed_everything(7)
    assert torch.equal(torch.randn(3), a)
