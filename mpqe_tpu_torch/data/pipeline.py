"""Background batch pipeline: packing on a producer thread, copies to the
card ahead of use (counterpart of ``mpqe_tpu/data/pipeline.py``).

The producer thread packs batches (the C++ packer of ``data/native.py``
when it builds, the numpy packer otherwise) and keeps ``prefetch`` of
them in a queue, so the train loop does not wait on the host while a
step runs.  On the card a batch's eight arrays are laid out in one
pinned buffer (:func:`host_buffer`) and copied with one
``non_blocking=True`` copy on a CUDA stream of the producer's own, after
which an event is recorded; the device arrays are views of the copy
(:func:`buffer_views`).  One buffer and one copy keep the producer's
Python work small: it shares the interpreter lock with the train loop,
which is itself host-bound.  :meth:`BatchPipeline.__next__` makes the
consumer's current stream wait on the batch's event before the first
use, marks the device buffer as used on the consumer's stream
(``record_stream``: it was allocated on the copy stream), and holds the
pinned buffer until the copy's event has completed.

Deterministic: the producer draws (structure, formula, pick, hard
negatives, seed) from its own ``np.random.default_rng(seed)`` through
:func:`draw_batch`, as ``train/loop.py run_train(prefetch=0)`` does, so
the same seed gives both the same batches within a curriculum phase.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from mpqe_tpu_torch.data import native as native_mod
from mpqe_tpu_torch.data.batcher import DenseQueryBatch
from mpqe_tpu_torch.data.store import FormulaStore, pack_dense_batch_np
from mpqe_tpu_torch.queries import INTERSECTION_STRUCTURES

ARRAY_FIELDS = ("node_entity", "node_mode", "edge_rel", "edge_norm",
                "target", "negatives", "neg_mask", "query_mask")


_ALIGN = 16  # bytes: each array's offset in a batch's buffer
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


@dataclasses.dataclass
class _Item:
    """One produced batch: its arrays (views of one device buffer on the
    card), and on the card that buffer, the copy's event and the pinned
    host buffer."""

    batch: DenseQueryBatch
    event: Optional[torch.cuda.Event] = None
    host: Optional[torch.Tensor] = None
    device: Optional[torch.Tensor] = None


class _Failed:
    """A producer exception, handed to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class BatchPipeline:
    """Produces packed ``DenseQueryBatch``es ahead of consumption.

    Args:
      stores: ``{structure: [FormulaStore]}`` (``data.store.build_stores``).
      batch_size, n_neg: the batch shape.
      structures: the structures to draw from (uniformly), or None: all.
      hard_neg_prob: P(hard negatives) on intersection structures.
      seed: the draw sequence's seed.
      prefetch: queue depth.
      device: None or a CPU device leaves the arrays as numpy arrays on
        the host; a CUDA device copies them to it (see the module doc).
      steps_per_call: K > 1 emits K same-formula batches stacked on a
        leading ``[K]`` axis (the multistep step's input).
    """

    def __init__(
        self,
        stores: Dict[str, List[FormulaStore]],
        batch_size: int,
        n_neg: int,
        structures: Optional[List[str]] = None,
        hard_neg_prob: float = 0.5,
        seed: int = 0,
        prefetch: int = 2,
        device=None,
        steps_per_call: int = 1,
    ):
        self.stores = {s: v for s, v in stores.items() if v}
        self.structures = structures or sorted(self.stores)
        self.batch_size = batch_size
        self.n_neg = n_neg
        self.hard_neg_prob = hard_neg_prob
        self.rng = np.random.default_rng(seed)
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda" and \
                self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.steps_per_call = steps_per_call
        self.pack = packer()
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None
        # (event, pinned buffers) of batches handed out whose copy may
        # still be running
        self._held: "collections.deque" = collections.deque()

    # ------------------------------------------------------------------
    def _make_one(self) -> DenseQueryBatch:
        return draw_batch(self.rng, self.stores, self.structures,
                          self.batch_size, self.n_neg, self.hard_neg_prob,
                          self.steps_per_call, self.pack)

    def _producer(self):
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                item = _to_device(self._make_one(), self.device,
                                  self._stream)
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by __next__
            self._put(_Failed(e))

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # ------------------------------------------------------------------
    def start(self) -> "BatchPipeline":
        if self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
        if self._stream is not None:
            self._stream.synchronize()
        self._held.clear()

    def __enter__(self) -> "BatchPipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __iter__(self) -> Iterator[DenseQueryBatch]:
        return self

    def __next__(self) -> DenseQueryBatch:
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    raise RuntimeError("the batch producer is not running")
        if isinstance(item, _Failed):
            raise item.exc
        if item.event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(item.event)
            item.device.record_stream(consumer)
            self._held.append((item.event, item.host))
            while self._held and self._held[0][0].query():
                self._held.popleft()
        return item.batch


def packer():
    """The C++ packer when it builds, else the numpy packer (the same
    signature; bit-equal batches for a seed within each)."""
    return (native_mod.pack_dense_batch_native if native_mod.available()
            else pack_dense_batch_np)


def draw_batch(rng: np.random.Generator,
               stores: Dict[str, List[FormulaStore]],
               structures: List[str], batch_size: int, n_neg: int,
               hard_neg_prob: float, steps_per_call: int = 1,
               pack=None) -> DenseQueryBatch:
    """One draw of the training loop from ``rng``: a structure (uniform
    over ``structures``), one of its formula stores, a pick of queries,
    hard negatives or not (intersection structures only), a packing
    seed.  With K = ``steps_per_call`` > 1, K-1 more (pick, seed) pairs
    of the same formula follow, and the K batches come stacked on a
    leading ``[K]`` axis.  ``run_train(prefetch=0)`` and the producer
    thread both draw through here, so a seed gives both the same
    batches.  ``pack`` defaults to :func:`packer`'s."""
    pack = pack or packer()
    structure = structures[rng.integers(len(structures))]
    f_stores = stores[structure]
    fstore = f_stores[rng.integers(len(f_stores))]

    def pick():
        return rng.integers(0, fstore.n_queries,
                            size=min(batch_size, fstore.n_queries)
                            ).astype(np.int64)

    picks = [pick()]
    use_hard = (structure in INTERSECTION_STRUCTURES
                and rng.random() < hard_neg_prob)
    seeds = [int(rng.integers(2**62))]
    for _ in range(steps_per_call - 1):
        picks.append(pick())
        seeds.append(int(rng.integers(2**62)))
    batches = [pack(fstore, pk, batch_size, n_neg, sd, use_hard)
               for pk, sd in zip(picks, seeds)]
    return batches[0] if steps_per_call <= 1 else stack_batches(batches)


def stack_batches(batches) -> DenseQueryBatch:
    """K same-structure batches -> one batch whose arrays carry a leading
    ``[K]`` axis (the multistep step's layout), stacked on the producer
    thread."""
    first = batches[0]
    return dataclasses.replace(first, **{
        f: np.stack([np.asarray(getattr(b, f)) for b in batches])
        for f in ARRAY_FIELDS})


def host_buffer(batch: DenseQueryBatch, pin: bool = False) -> tuple:
    """The batch's arrays in one uint8 buffer (pinned with ``pin``), each
    at an offset aligned to _ALIGN bytes: ``(buffer, layout)`` with
    ``layout`` a (field, offset, bytes, dtype, shape) per array."""
    arrays = [np.ascontiguousarray(getattr(batch, f)) for f in ARRAY_FIELDS]
    layout, off = [], 0
    for f, a in zip(ARRAY_FIELDS, arrays):
        layout.append((f, off, a.nbytes, _TORCH_DTYPES[a.dtype], a.shape))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    buf = torch.empty((off,), dtype=torch.uint8, pin_memory=pin)
    raw = buf.numpy()
    for (_, o, n, _, _), a in zip(layout, arrays):
        raw[o:o + n] = a.reshape(-1).view(np.uint8)
    return buf, layout


def buffer_views(buf: torch.Tensor, layout) -> dict:
    """``{field: tensor}``: the arrays of :func:`host_buffer`'s layout as
    views of ``buf`` (a copy of the buffer, on any device)."""
    return {f: buf[o:o + n].view(dtype).view(shape)
            for f, o, n, dtype, shape in layout}


def _to_device(batch: DenseQueryBatch, device, stream) -> _Item:
    """The batch in one pinned buffer, copied to ``device`` on ``stream``
    with an event recorded after the copy, its arrays views of the copy;
    without a stream (no device, or the CPU) the arrays stay numpy arrays
    on the host."""
    if stream is None:
        return _Item(batch)
    host, layout = host_buffer(batch, pin=True)
    with torch.cuda.stream(stream):
        dev = host.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return _Item(dataclasses.replace(batch, **buffer_views(dev, layout)),
                 event, host, dev)
