"""Checkpointing of the full training state (counterpart of
``mpqe_tpu/train/checkpoint.py``): model parameters, optimizer state and
step, so a run resumes exactly.

Same run-dir layout as the reference: ``ckpt/step_<N>/`` per checkpoint,
``ckpt/scores.json`` for best-k retention.  A checkpoint directory holds
one ``state.pt`` (``torch.save`` of ``{"model", "optimizer", "step"}``
state dicts); it is written to a temporary directory and renamed into
place, so an interrupted save never leaves a ``step_<N>`` that
:func:`latest_checkpoint` would pick.  Saves are synchronous.  A model
on a mesh (``parallel/sharding.py``) writes the unsharded layout: its
tables whole and its optimizer state as an unsharded run's, and reads
either back into its own layout.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import List, Optional, Tuple

import torch

from mpqe_tpu_torch.parallel import sharding as sharding_lib

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, state) -> str:
    """Save ``state`` (a ``loop.TrainState``) as ``ckpt_dir/step_<N>``,
    replacing one of the same step; returns its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{state.step}"))
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"step_{state.step}.tmp-", dir=ckpt_dir)
    torch.save({"model": state.model.state_dict(),
                "optimizer": sharding_lib.optimizer_state_dict(
                    state.model, state.optimizer),
                "step": int(state.step)}, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, template):
    """Load a checkpoint into ``template`` (a ``loop.TrainState`` whose
    model and optimizer have the saved shapes) and return it."""
    payload = torch.load(os.path.join(path, STATE_FILE),
                         map_location=template.model.emb.ent.device,
                         weights_only=True)
    template.model.load_state_dict(payload["model"])
    sharding_lib.load_optimizer_state_dict(template.model, template.optimizer,
                                           payload["optimizer"])
    template.step = int(payload["step"])
    return template


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest committed checkpoint (temporary dirs of interrupted saves
    fail the step parse and are skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_")[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


class CheckpointManager:
    """Best-k checkpointing: checkpoints saved with a metric take part in
    best-k retention (the worst are deleted beyond ``keep_best``);
    metric-less saves (the final one) are never pruned.  The scores live
    in ``scores.json`` beside the checkpoints, so a resumed run keeps
    retiring them."""

    def __init__(self, ckpt_dir: str, keep_best: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_best = keep_best
        self._scores_path = os.path.join(ckpt_dir, "scores.json")
        self._scored: List[Tuple[float, int, str]] = self._load_scores()
        if self._scored:
            self._prune()

    def _load_scores(self) -> List[Tuple[float, int, str]]:
        if not os.path.exists(self._scores_path):
            return []
        try:
            with open(self._scores_path) as f:
                entries = json.load(f)
        except (OSError, ValueError):
            return []
        out = []
        for e in entries:
            path = e["path"]
            if not os.path.isabs(path):
                path = os.path.abspath(os.path.join(self.ckpt_dir, path))
            if os.path.isdir(path):
                out.append((float(e["metric"]), int(e["step"]), path))
        return out

    def _save_scores(self) -> None:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        tmp = self._scores_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump([{"metric": m, "step": s,
                        "path": os.path.relpath(p, self.ckpt_dir)}
                       for m, s, p in self._scored], f)
        os.replace(tmp, self._scores_path)

    def save(self, state, metric: Optional[float] = None) -> str:
        """Save now (synchronously)."""
        path = save_checkpoint(self.ckpt_dir, state)
        if metric is not None:
            self._scored = [t for t in self._scored if t[2] != path]
            self._scored.append((float(metric), state.step, path))
            self._prune()
            self._save_scores()
        return path

    def _prune(self) -> None:
        if len(self._scored) <= self.keep_best:
            return
        self._scored.sort(key=lambda t: (t[0], t[1]))
        while len(self._scored) > self.keep_best:
            _, _, path = self._scored.pop(0)
            if os.path.isdir(path):
                shutil.rmtree(path)
        self._save_scores()

    def best(self) -> Optional[str]:
        if not self._scored:
            return None
        return max(self._scored, key=lambda t: (t[0], t[1]))[2]
