"""Training loop: curriculum, train steps, convergence checks (counterpart
of ``mpqe_tpu/train/loop.py``).

Each step samples a random formula within a random query structure and
runs a margin-ranking batch; the curriculum trains 1-chain queries only
until the loss converges (burn-in), then mixes all structures; periodic
validation checkpoints on best and stops early on a plateau.

The optimizer follows optax's formulas step by step (:class:`OptaxAdam`,
:func:`make_optimizer`): torch's own Adam places ``eps`` and the bias
corrections differently and ``clip_grad_norm_`` adds 1e-6 to the norm.
Batches are packed by the C++ packer (``data/native.py``) when it builds,
else by the numpy packer (``data/store.py``), as in the reference;
``prefetch > 0`` packs them on a producer thread and copies them to the
card ahead of use (``data/pipeline.py``).  ``steps_per_call = K`` takes
K steps per call (:func:`make_multistep_train_step`): eager PyTorch has
no ``lax.scan``, so the K steps run one after another in one Python
call, their losses stay on the device, and the host reads them once per
call: one synchronisation per K steps instead of K.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpqe_tpu_torch.data.batcher import DenseQueryBatch
from mpqe_tpu_torch.models import mpqe as mpqe_mod
from mpqe_tpu_torch.queries import Formula, Query
from mpqe_tpu_torch.train import evaluation

@dataclasses.dataclass
class TrainConfig:
    lr: float = 0.01
    # const | cosine (decay to lr/100 over max_steps) | warmup_cosine
    # (linear 0 -> lr over warmup_steps, then cosine to lr/100)
    lr_schedule: str = "const"
    warmup_steps: int = 0
    grad_clip_norm: float = 0.0  # 0 = no clipping
    weight_decay: float = 0.0  # >0 switches adam -> adamw
    batch_size: int = 512
    n_neg: int = 1
    max_steps: int = 100_000
    burn_in_structure: str = "1-chain"
    conv_window: int = 100  # loss window for convergence checks
    conv_tol: float = 1e-4
    val_every: int = 1000
    patience: int = 5  # eval rounds without val improvement -> stop
    hard_neg_prob: float = 0.5  # P(use hard negatives) on intersection batches
    hard_margin: float = 0.0  # margin of hard-negative batches (0 = cfg's)
    seed: int = 0
    optimizer: str = "adam"


def cosine_decay(init: float, decay_steps: int, alpha: float, count: int
                 ) -> float:
    """``optax.cosine_decay_schedule(init, decay_steps, alpha)(count)``."""
    c = min(count, decay_steps)
    return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
                   + alpha)


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """The learning rate as a function of the update count before it is
    incremented (optax's ``scale_by_schedule`` convention)."""
    if tc.lr_schedule == "cosine":
        decay = max(tc.max_steps, 1)
        return lambda c: cosine_decay(tc.lr, decay, 0.01, c)
    if tc.lr_schedule == "warmup_cosine":
        w = max(tc.warmup_steps, 1)
        decay = max(tc.max_steps, w + 1) - w

        def f(c):
            if c < w:  # linear_schedule(0, lr, w)
                return (0.0 - tc.lr) * (1 - min(max(c, 0), w) / w) + tc.lr
            return cosine_decay(tc.lr, decay, 0.01, c - w)

        return f
    if tc.lr_schedule == "const":
        return lambda c: tc.lr
    raise ValueError(tc.lr_schedule)


class OptaxAdam(torch.optim.Optimizer):
    """``optax.{adam, adamw, sgd}`` (b1 0.9, b2 0.999, eps 1e-8), optionally
    behind ``optax.clip_by_global_norm``, as a torch optimizer:

    * clip: ``norm = sqrt(sum of g^2 over every leaf)``; when
      ``norm >= max_norm`` every ``g`` becomes ``(g / norm) * max_norm``;
    * adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
      ``u = (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)`` with ``t`` the
      incremented count; adamw adds ``weight_decay * p`` to ``u`` (every
      parameter, the entity table included);
    * sgd: ``u = g``;
    * ``p += u * -lr(count)``, the schedule read at the count before the
      increment.

    A parameter without a gradient counts as a zero gradient, as in JAX.
    The update count lives in the param group, so ``state_dict()``
    carries it.

    bfloat16 parameters keep ``mu`` and ``nu`` in bf16 (``zeros_like``,
    as ``optax.adam`` does) and follow optax's rounding points there:
    every operation rounds to bf16, and every scalar (``b1``, ``1 - b1``,
    ``eps``, the step size, ...) is first rounded to bf16, as JAX rounds
    a weakly typed Python scalar into a bf16 array's dtype; ``1 - b^t``
    is taken in f32 and then rounded, as optax's bias correction does.
    (So ``b2 = 0.999`` acts as bf16's 1.0.)  The clip's global norm sums
    each leaf's squares in the leaf's dtype, on the first leaf's device
    (the blocks of a row-sharded table may live on several)."""

    def __init__(self, params, tc: TrainConfig):
        if tc.optimizer not in ("adam", "sgd"):
            raise ValueError(tc.optimizer)
        if tc.optimizer == "sgd" and tc.weight_decay > 0:
            raise ValueError("weight_decay requires optimizer='adam'")
        super().__init__(params, dict(count=0))
        self.kind = tc.optimizer
        self.weight_decay = tc.weight_decay
        self.max_norm = tc.grad_clip_norm
        self.lr = lr_schedule(tc)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.max_norm > 0:
            dev = grads[0].device
            norm = torch.sqrt(sum(torch.sum(g * g).to(dev) for g in grads))
            if not bool(norm < self.max_norm):
                grads = [(g / norm.to(g.device, g.dtype))
                         * _rounded(self.max_norm, g.dtype)
                         for g in grads]
        count = group["count"]
        step_size = -self.lr(count)
        t = count + 1
        # 1 - b^t in float32, as optax computes it (the cancellation makes
        # its rounding visible: XLA's f32 pow and torch's differ by an ulp
        # of b2^t for some t, 2e-5 of 1 - b2^t at t = 3)
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(self.b1, dtype=f32) ** t)
        bc2 = float(1 - torch.tensor(self.b2, dtype=f32) ** t)
        scalars = {}
        for p, g in zip(params, grads):
            if p.dtype not in scalars:
                scalars[p.dtype] = [_rounded(v, p.dtype) for v in (
                    step_size, self.b1, 1 - self.b1, self.b2, 1 - self.b2,
                    bc1, bc2, self.eps, self.weight_decay)]
            step, b1, c1, b2, c2, bc1_p, bc2_p, eps, wd = scalars[p.dtype]
            if self.kind == "sgd":
                p.add_(g * step)
                continue
            st = self.state[p]
            if not st:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
            mu, nu = st["mu"], st["nu"]
            # each operation rounds once to the parameter's dtype: optax's
            # rounding points (in bf16 too, its scalars rounded first)
            mu.mul_(b1).add_(g * c1)
            nu.mul_(b2).add_((g * g) * c2)
            u = (mu / bc1_p) / (torch.sqrt(nu / bc2_p) + eps)
            if self.weight_decay > 0:
                u = u + wd * p
            p.add_(u * step)
        for g in self.param_groups:
            g["count"] = t
        return None


def _rounded(v: float, dtype) -> float:
    """The Python float ``v`` rounded to ``dtype`` through f32, as JAX
    rounds a weakly typed Python scalar into a bf16 array's dtype (for an
    f32 tensor PyTorch rounds it so itself)."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def make_optimizer(tc: TrainConfig, params) -> OptaxAdam:
    return OptaxAdam(params, tc)


@dataclasses.dataclass
class TrainState:
    model: Any  # mpqe.MPQE or gqe.GQE
    optimizer: OptaxAdam
    step: int = 0


def make_train_step(cfg, optimizer: OptaxAdam,
                    batch_loss_fn: Optional[Callable] = None,
                    reduce_grads: Optional[Callable] = None) -> Callable:
    """``step(model, structure, *batch tensors) -> loss``: value and
    gradient of ``batch_loss_fn(model, cfg, structure, *tensors)``
    (default :func:`models.mpqe.dense_batch_loss`), then the optimizer
    update, in place.  ``reduce_grads(loss) -> loss``, when given, runs
    between the backward and the update (the data-parallel step sums the
    processes' gradients there, ``parallel/spmd.py``)."""
    if batch_loss_fn is None:
        batch_loss_fn = mpqe_mod.dense_batch_loss

    def step_fn(model, structure, node_entity, node_mode, edge_rel,
                edge_norm, target, negatives, neg_mask, query_mask):
        optimizer.zero_grad(set_to_none=True)
        loss = batch_loss_fn(model, cfg, structure, node_entity, node_mode,
                             edge_rel, edge_norm, target, negatives,
                             neg_mask, query_mask)
        loss.backward()
        loss = loss.detach()
        if reduce_grads is not None:
            loss = reduce_grads(loss)
        optimizer.step()
        return loss

    return step_fn


def make_multistep_train_step(cfg, optimizer: OptaxAdam,
                              batch_loss_fn: Optional[Callable] = None,
                              reduce_grads: Optional[Callable] = None
                              ) -> Callable:
    """``step(model, structure, *batch tensors with a leading [K] axis)
    -> losses [K]``: K train steps of :func:`make_train_step`, one per
    slice of the stacked batch, in one call.  A field may also be a list
    of per-part tensors, each with the leading ``[K]`` axis (a batch
    split over a mesh's data parts).  The losses stay on the device (the
    reference's ``lax.scan`` returns them so), so a caller that reads
    them once synchronises once per K steps."""
    one = make_train_step(cfg, optimizer, batch_loss_fn, reduce_grads)

    def at(a, i):
        return [t[i] for t in a] if isinstance(a, (list, tuple)) else a[i]

    def step_fn(model, structure, *stacked):
        first = stacked[0]
        k = (first[0] if isinstance(first, (list, tuple)) else first
             ).shape[0]
        return torch.stack([one(model, structure, *(at(a, i) for a in stacked))
                            for i in range(k)])

    return step_fn


BATCH_FIELDS = ("node_entity", "node_mode", "edge_rel", "edge_norm",
                "target", "negatives", "neg_mask", "query_mask")


def batch_tensors(batch: DenseQueryBatch, device) -> List[torch.Tensor]:
    """The batch's arrays as tensors on ``device``; tensors already there
    (the pipeline's copies) are taken as they are."""
    return [torch.as_tensor(np.ascontiguousarray(a)
                            if isinstance(a, np.ndarray) else a)
            .to(device, non_blocking=True)
            for a in (getattr(batch, f) for f in BATCH_FIELDS)]


def run_step(train_step: Callable, state: TrainState,
             batch: DenseQueryBatch,
             put_batch: Optional[Callable] = None) -> float:
    """One step on ``batch``, its arrays placed by ``put_batch(batch)``
    (a list of fields in ``BATCH_FIELDS`` order), by default as tensors
    on the entity table's device."""
    loss = train_step(state.model, batch.structure,
                      *_placed(state, batch, put_batch))
    state.step += 1
    return float(loss)


def _placed(state: TrainState, batch: DenseQueryBatch,
            put_batch: Optional[Callable]) -> list:
    if put_batch is not None:
        return put_batch(batch)
    return batch_tensors(batch, state.model.emb.ent.device)


def run_multistep(train_step: Callable, state: TrainState,
                  batches: Sequence[DenseQueryBatch],
                  put_batch: Optional[Callable] = None) -> List[float]:
    """Stack K same-structure batches and take K steps in one call."""
    from mpqe_tpu_torch.data.pipeline import stack_batches

    return run_multistep_stacked(train_step, state, stack_batches(batches),
                                 put_batch)


def run_multistep_stacked(train_step: Callable, state: TrainState,
                          batch: DenseQueryBatch,
                          put_batch: Optional[Callable] = None
                          ) -> List[float]:
    """One call of a multistep step over a batch already stacked on a
    leading ``[K]`` axis (by ``BatchPipeline(steps_per_call=K)`` on its
    thread; ``put_batch`` as for :func:`run_step`, given the stack); the
    K losses are read from the device once."""
    losses = train_step(state.model, batch.structure,
                        *_placed(state, batch, put_batch))
    state.step += int(losses.shape[0])
    return losses.tolist()


def check_conv(losses: collections.deque, tol: float) -> bool:
    """Converged when the relative improvement between the two halves of
    the loss window falls below tol (reference check_conv semantics)."""
    if len(losses) < losses.maxlen:
        return False
    arr = np.asarray(losses)
    half = len(arr) // 2
    old, new = arr[:half].mean(), arr[half:].mean()
    if old <= 0:
        return True
    return (old - new) / abs(old) < tol


def warmup_train_step(train_step_factory: Callable, cfg, tc: TrainConfig,
                      structures, device) -> None:
    """Run one throwaway step per structure at the run's batch shape on a
    throwaway model and optimizer, ahead of the loop (first kernel
    builds, library handles, allocator pools)."""
    from mpqe_tpu_torch.queries import STRUCTURES as _S

    if not isinstance(cfg, mpqe_mod.MPQEConfig):
        return
    gen = torch.Generator(device=device).manual_seed(0)
    model = mpqe_mod.init_mpqe(gen, cfg, device=device)
    step = train_step_factory(make_optimizer(tc, model.parameters()))
    B, K = tc.batch_size, tc.n_neg
    for structure in structures:
        spec = _S[structure]

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        step(model, structure, z(B, spec.n_nodes), z(B, spec.n_nodes),
             z(spec.n_edges),
             torch.ones(spec.n_edges, device=device), z(B), z(B, K),
             torch.ones((B, K), device=device), torch.ones(B, device=device))


def run_train(
    state: TrainState,
    cfg,
    tc: TrainConfig,
    train_queries: Dict[str, Dict[Formula, List[Query]]],
    val_queries: Optional[Dict[str, Dict[Formula, List[Query]]]] = None,
    log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
    checkpoint_fn: Optional[Callable[[TrainState, float], None]] = None,
    train_step: Optional[Callable] = None,
    batch_loss_fn: Optional[Callable] = None,
    eval_encode_fn: Optional[Callable] = None,
    kg=None,
    warmup: bool = False,
    prefetch: int = 0,
    steps_per_call: int = 1,
    train_stores=None,
    should_stop: Optional[Callable[[], bool]] = None,
    neighbor_table=None,
    multi_step: Optional[Callable] = None,
    put_batch: Optional[Callable] = None,
    trace: Optional[Tuple[int, int, str]] = None,
) -> TrainState:
    """Curriculum training until convergence / max_steps / patience, in
    place on ``state``.  ``should_stop`` is polled each step (True stops
    cleanly: graceful preemption).  Each step's record for ``log_fn``
    carries its seconds, the loss included (the step ends on the host
    reading the loss).  Validation takes the batched sweep
    (``evaluate_batched``), or with ``eval_encode_fn`` the per-formula
    protocol through that encoder (``evaluate``), as in the reference;
    it runs whenever the step count crosses a ``val_every`` boundary.
    ``neighbor_table`` (a GQE neighborhood encoder's table) goes to the
    validation sweep; the loss gets it bound in ``batch_loss_fn``.

    ``prefetch > 0`` takes batches from a ``data/pipeline.py
    BatchPipeline`` of that depth, one per curriculum phase (restarted
    from ``tc.seed`` at the burn-in switch, as the reference does).
    ``steps_per_call > 1`` takes that many same-formula steps per call of
    :func:`make_multistep_train_step` (of the default step; a custom
    ``train_step`` comes with its own ``multi_step``, else it raises),
    and its records carry ``loss`` (the last), ``loss_mean_k`` and
    ``k``.  ``put_batch(batch)`` places each batch's arrays (``run_step``;
    the data-parallel step splits them over its mesh), by default on the
    entity table's device.

    ``trace = (skip, n, log_dir)`` opens a ``torch.profiler`` window
    (``utils/profiling.py start_trace``) at the first step boundary at
    or past ``state.step + skip`` and closes it, writing a Chrome trace
    under ``log_dir``, at the first at or past ``state.step + skip +
    max(n, 1)``, as the reference's ``jax.profiler`` window.  With K
    steps a call the boundaries stride by K, so the window holds whole
    calls (skip 10, n 5, K 4: steps 12..16).  It logs ``trace_start``
    and ``trace_done`` (with the window's
    :class:`utils.profiling.StepTimer` summary) at the step counts where
    it opens and closes; a step that raises inside the window still
    closes it."""
    from mpqe_tpu_torch.data.pipeline import draw_batch, packer
    from mpqe_tpu_torch.data.store import build_stores

    rng = np.random.default_rng(tc.seed)
    device = state.model.emb.ent.device
    hard_step = hard_multi = None
    if train_step is None:
        train_step = make_train_step(cfg, state.optimizer, batch_loss_fn)
        if steps_per_call > 1:
            multi_step = make_multistep_train_step(cfg, state.optimizer,
                                                   batch_loss_fn)
        if tc.hard_margin > 0.0:
            hcfg = dataclasses.replace(cfg, margin=tc.hard_margin)
            hard_step = make_train_step(hcfg, state.optimizer, batch_loss_fn)
            if steps_per_call > 1:
                hard_multi = make_multistep_train_step(
                    hcfg, state.optimizer, batch_loss_fn)
    elif tc.hard_margin > 0.0:
        raise ValueError("hard_margin needs the default train step")
    elif steps_per_call > 1 and multi_step is None:
        raise ValueError("steps_per_call > 1 needs the default train step "
                         "(batch_loss_fn picks the loss) or multi_step")
    if steps_per_call <= 1:
        multi_step = None

    stores = (train_stores if train_stores is not None
              else build_stores(train_queries, kg=kg))
    pack = packer()
    k = steps_per_call if multi_step is not None else 1
    structures = [s for s in stores if stores[s]]
    if warmup:
        warmup_train_step(
            lambda opt: make_train_step(cfg, opt, batch_loss_fn), cfg, tc,
            structures, device)
    eval_set = (evaluation.make_eval_set(val_queries)
                if val_queries and eval_encode_fn is None else None)

    def run_validation():
        if eval_set is not None:
            return evaluation.evaluate_batched(
                state.model, cfg, eval_set, neighbor_table=neighbor_table)
        return evaluation.evaluate(state.model, cfg, val_queries,
                                   encode_fn=eval_encode_fn)

    burn_in = tc.burn_in_structure in structures and len(structures) > 1
    losses: collections.deque = collections.deque(maxlen=tc.conv_window)
    best_val = -np.inf
    bad_evals = 0
    phase = "burn_in" if burn_in else "full"
    # validation fires on crossing a val_every boundary (with K steps a
    # call the count strides by K)
    last_val_bucket = state.step // tc.val_every

    def make_pipeline(ph):
        from mpqe_tpu_torch.data.pipeline import BatchPipeline

        return BatchPipeline(
            stores, batch_size=tc.batch_size, n_neg=tc.n_neg,
            structures=([tc.burn_in_structure] if ph == "burn_in"
                        else structures),
            hard_neg_prob=tc.hard_neg_prob, seed=tc.seed, prefetch=prefetch,
            device=device,
            steps_per_call=k).start()

    pipeline = make_pipeline(phase) if prefetch > 0 else None
    trace_start = trace_stop = -1
    prof = window = None
    if trace is not None:
        from mpqe_tpu_torch.utils import profiling

        skip, n_trace, trace_dir = trace
        trace_start = state.step + skip
        trace_stop = trace_start + max(n_trace, 1)
    target_step = state.step + tc.max_steps
    try:
        while state.step < target_step:
            if should_stop is not None and should_stop():
                if log_fn:
                    log_fn({"step": state.step, "event": "preempt_stop"})
                break
            if trace_start >= 0 and prof is None and \
                    state.step >= trace_start:
                prof = profiling.start_trace(trace_dir)
                window = profiling.StepTimer()
                if log_fn:
                    log_fn({"step": state.step, "event": "trace_start",
                            "trace_dir": trace_dir})
            if pipeline is not None:
                batch = next(pipeline)
            else:
                batch = draw_batch(
                    rng, stores, ([tc.burn_in_structure] if phase == "burn_in"
                                  else structures),
                    tc.batch_size, tc.n_neg, tc.hard_neg_prob, k, pack)
            structure = batch.structure
            t0 = time.perf_counter()
            use_hard_margin = hard_step is not None and batch.used_hard
            if multi_step is not None:
                ms = hard_multi if use_hard_margin else multi_step
                # K same-formula batches stacked on a leading [K] axis
                k_losses = run_multistep_stacked(ms, state, batch, put_batch)
                dt = time.perf_counter() - t0
                losses.extend(k_losses)
                loss = k_losses[-1]
                if log_fn:
                    log_fn({"step": state.step, "loss": loss,
                            "loss_mean_k": float(np.mean(k_losses)),
                            "structure": structure, "phase": phase,
                            "seconds": dt, "k": len(k_losses)})
            else:
                loss = run_step(hard_step if use_hard_margin else train_step,
                                state, batch, put_batch)
                dt = time.perf_counter() - t0
                losses.append(loss)
                if log_fn:
                    log_fn({"step": state.step, "loss": loss,
                            "structure": structure, "phase": phase,
                            "seconds": dt})
            if prof is not None:
                n_call = len(k_losses) if multi_step is not None else 1
                window.samples.extend([dt / n_call] * n_call)
                if state.step >= trace_stop:
                    profiling.stop_trace(prof, trace_dir)
                    prof, trace_start = None, -1
                    if log_fn:
                        log_fn({"step": state.step, "event": "trace_done",
                                "trace_dir": trace_dir,
                                "window": window.summary()})

            if phase == "burn_in" and check_conv(losses, tc.conv_tol):
                phase = "full"
                losses.clear()
                if pipeline is not None:
                    pipeline.stop()
                    pipeline = make_pipeline(phase)
                if log_fn:
                    log_fn({"step": state.step, "event": "burn_in_done"})

            if val_queries and state.step // tc.val_every > last_val_bucket:
                last_val_bucket = state.step // tc.val_every
                res = run_validation()
                metric = res.macro_auc
                if log_fn:
                    log_fn({"step": state.step, "val": res.flat()})
                if not np.isfinite(metric):
                    if log_fn:
                        log_fn({"step": state.step,
                                "event": "val_unscoreable_skipped"})
                elif metric > best_val:
                    best_val = metric
                    bad_evals = 0
                    if checkpoint_fn:
                        checkpoint_fn(state, metric)
                else:
                    bad_evals += 1
                    if bad_evals >= tc.patience and phase == "full":
                        if log_fn:
                            log_fn({"step": state.step,
                                    "event": "early_stop"})
                        break
            elif phase == "full" and not val_queries and \
                    check_conv(losses, tc.conv_tol):
                break
    finally:
        # a step that raises inside the window must not leave a live
        # profiler behind (it would refuse the next one in this process)
        if prof is not None:
            profiling.stop_trace(prof, trace_dir)
        if pipeline is not None:
            pipeline.stop()
    return state


def init_train_state(gen: torch.Generator, cfg, tc: TrainConfig,
                     device=None,
                     init_fn: Optional[Callable] = None) -> TrainState:
    """A fresh model from ``gen`` on ``device`` (``init_fn(gen, cfg,
    device=...)``, by default ``init_mpqe``) and its optimizer."""
    model = (init_fn or mpqe_mod.init_mpqe)(gen, cfg, device=device)
    return TrainState(model=model,
                      optimizer=make_optimizer(tc, model.parameters()))
