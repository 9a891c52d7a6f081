"""The port's background batch pipeline (``mpqe_tpu_torch/data/
pipeline.py``) against the JAX package's (``device_put=False``) on the
CPU: the same seed gives the same batches, bit for bit, at
``steps_per_call`` 1 and 4, with the C++ packer and with the numpy
packer; on the CPU the arrays stay numpy arrays on the host; a producer
error reaches the consumer; ``stop`` is idempotent.  The copies to the
card (pinned buffers, the copy stream's events) are tested on the card in
``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from mpqe_tpu.data import native as jnat
from mpqe_tpu.data import pipeline as jpipe
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data import store as jstore
from mpqe_tpu.queries import group_queries_by_formula as jgroup
from mpqe_tpu_torch.data import native as tnat
from mpqe_tpu_torch.data import pipeline as tpipe
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.data import store as tstore
from mpqe_tpu_torch.queries import group_queries_by_formula as tgroup

N_BATCHES = 12
FIELDS = tpipe.ARRAY_FIELDS


@pytest.fixture(scope="module")
def stores():
    kw = dict(n_entities=80, n_modes=2, n_base_rels=3, n_triples=500,
              seed=31)
    out = []
    for samp, store, group in ((jsamp, jstore, jgroup),
                               (tsamp, tstore, tgroup)):
        s = samp.QuerySampler(samp.make_random_kg(**kw), seed=8)
        qs = (s.sample_queries("1-chain", 60, n_neg=8)
              + s.sample_queries("2-inter", 60, n_neg=8, n_hard_neg=8)
              + s.sample_queries("3-chain", 30, n_neg=8))
        out.append(store.build_stores(group(qs)))
    return out


def _draw(pipe, n=N_BATCHES):
    with pipe:
        return [next(pipe) for _ in range(n)]


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("k", [1, 4])
def test_pipeline_matches_jax(stores, k, native, monkeypatch):
    if native and not (tnat.available() and jnat.available()):
        pytest.skip("C++ host library not buildable")
    if not native:
        monkeypatch.setattr(tnat, "available", lambda: False)
        monkeypatch.setattr(jnat, "available", lambda: False)
    js, ts = stores
    kw = dict(batch_size=16, n_neg=4, hard_neg_prob=0.5, seed=5,
              prefetch=3, steps_per_call=k)
    want = _draw(jpipe.BatchPipeline(js, device_put=False, **kw))
    got = _draw(tpipe.BatchPipeline(ts, **kw))
    lead = (k,) if k > 1 else ()
    for a, b in zip(want, got):
        assert (a.structure, a.n_queries, a.used_hard) == (
            b.structure, b.n_queries, b.used_hard)
        assert b.node_entity.shape == lead + (16, a.node_entity.shape[-1])
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert isinstance(y, np.ndarray), f  # left on the host
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, f)
    assert len({b.structure for b in got}) > 1


def test_pipeline_on_cpu_device_leaves_numpy(stores):
    _, ts = stores
    for b in _draw(tpipe.BatchPipeline(ts, 8, 2, seed=1, device="cpu"), 3):
        assert all(isinstance(getattr(b, f), np.ndarray) for f in FIELDS)


def test_pipeline_producer_error_reaches_consumer(stores, monkeypatch):
    _, ts = stores

    def boom(*a, **kw):
        raise RuntimeError("packer on fire")

    monkeypatch.setattr(tpipe, "pack_dense_batch_np", boom)
    monkeypatch.setattr(tnat, "pack_dense_batch_native", boom)
    pipe = tpipe.BatchPipeline(ts, 8, 2, seed=1).start()
    try:
        with pytest.raises(RuntimeError, match="packer on fire"):
            next(pipe)
    finally:
        pipe.stop()


def test_pipeline_stop_idempotent(stores):
    _, ts = stores
    pipe = tpipe.BatchPipeline(ts, batch_size=8, n_neg=2).start()
    next(pipe)
    pipe.stop()
    pipe.stop()
    assert not pipe._thread.is_alive()


@pytest.mark.parametrize("k", [1, 4])
def test_host_buffer_views_round_trip(stores, k):
    """On the card a batch travels as one buffer (one pinned copy): its
    arrays, read back as views of a copy of the buffer, equal the
    batch's, bit for bit, with their dtypes and shapes."""
    _, ts = stores
    with tpipe.BatchPipeline(ts, 16, 4, seed=2, steps_per_call=k) as pipe:
        batch = next(pipe)
    buf, layout = tpipe.host_buffer(batch)
    assert buf.dtype == torch.uint8 and not buf.is_pinned()
    assert all(o % 16 == 0 for _, o, _, _, _ in layout)
    views = tpipe.buffer_views(buf.clone(), layout)
    for f in FIELDS:
        want = torch.from_numpy(getattr(batch, f))
        assert views[f].dtype == want.dtype, f
        assert torch.equal(views[f], want), f


def test_stack_batches_matches_jax(stores):
    js, ts = stores
    a = [jstore.pack_dense_batch_np(js["3-chain"][0], np.arange(3), 8, 2, s)
         for s in range(3)]
    b = [tstore.pack_dense_batch_np(ts["3-chain"][0], np.arange(3), 8, 2, s)
         for s in range(3)]
    x, y = jpipe.stack_batches(a), tpipe.stack_batches(b)
    assert (x.structure, x.n_queries) == (y.structure, y.n_queries)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
