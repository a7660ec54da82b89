"""Training loop: grad accumulation, checkpoint/restart, failure injection,
straggler hook.

The port of ``repro.train.trainer``, on ``train/optimizer.py``'s
``value_and_grad`` and ``apply_updates`` and on ``train/checkpoint.py``.

- **checkpoint/restart**: atomic step-tagged saves every ``ckpt_every``
  steps and at the end; ``try_restore`` resumes from the newest complete
  one, and the loader is keyed by (seed, step, shard), so the token stream
  replays identically and a resumed run is the uninterrupted one bit for
  bit on the same device.
- **failure injection**: ``FailureInjector`` raises at a configured step;
  ``run_with_restarts`` is the supervisor that restarts from the latest
  checkpoint.
- **straggler hook**: a step that overruns ``step_deadline_s`` is recorded
  in ``straggler_log`` (on a cluster the runner would reschedule it).
- **donation**: the step updates the parameters and moments in place, as
  the reference's jitted step donates them, so a model's state is held
  once.  The elastic remesh (``checkpoint.restore(shardings=)``) restores
  a run's checkpoint onto another mesh, rank by rank
  (``distributed.world.CheckpointParams``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.common.tree import tree_map
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod


@dataclasses.dataclass
class TrainerConfig:
    """``ckpt_dir`` has no default: a run saves and restores there, so two
    runs must not share one by accident."""
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(kw_only=True)
    grad_accum: int = 1
    step_deadline_s: float | None = None  # straggler threshold
    async_checkpoint: bool = False


class FailureInjector:
    """Deterministic failure injection for fault-tolerance tests."""

    def __init__(self, fail_at_step: int | None = None,
                 fail_in_checkpoint: bool = False):
        self.fail_at_step = fail_at_step
        self.fail_in_checkpoint = fail_in_checkpoint
        self.fired = False

    def maybe_fail(self, step: int):
        if not self.fired and self.fail_at_step is not None and \
                step == self.fail_at_step:
            self.fired = True
            raise RuntimeError(f"injected node failure at step {step}")


def _own(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of ``t`` on ``device``, with the record of a tensor-parallel
    cut (``tp_dim``, and a copy of its ``tp_whole``) the layers read."""
    out = t.detach().to(device, copy=True)
    if hasattr(t, "tp_dim"):
        out.tp_dim = t.tp_dim
    if hasattr(t, "tp_whole"):
        out.tp_whole = t.tp_whole.detach().to(device, copy=True)
    return out


def _add(a, b):
    return None if a is None else a + b


def train_step(loss_fn: Callable, params, opt_state, batches, ocfg: opt_mod.AdamWConfig):
    """One optimizer step over ``batches``, a tree whose leaves carry a
    leading (accum, ...) microbatch axis: each microbatch's loss and grads
    summed in order, divided by ``accum``, then AdamW, donating ``params``
    and ``opt_state``.  Returns (params, opt_state, metrics) with ``loss``,
    ``grad_norm`` and ``lr`` as 0-d tensors.

    The reference sums from f32 zeros; 0 + x = x, so the port starts from
    the first microbatch (in f32 when there are more) and, at ``accum`` 1,
    skips the division by 1, which changes nothing either."""
    grad_fn = opt_mod.value_and_grad(loss_fn)
    accum = next(iter(batches.values())).shape[0]
    loss, grads = grad_fn(params, tree_map(lambda x: x[0], batches))
    if accum > 1:
        loss, grads = loss.float(), tree_map(lambda g: None if g is None else g.float(), grads)
        for i in range(1, accum):
            l, g = grad_fn(params, tree_map(lambda x, i=i: x[i], batches))
            loss, grads = loss + l, tree_map(_add, grads, g)
        n = torch.tensor(accum, dtype=torch.float32, device=loss.device)
        loss, grads = loss / n, tree_map(lambda g: None if g is None else g / n, grads)
    params, opt_state, metrics = opt_mod.apply_updates(params, grads, opt_state, ocfg,
                                                       donate=True)
    return params, opt_state, {"loss": loss, **metrics}


class Trainer:
    """``loss_fn(params, batch)`` trained on ``loader``'s batches on
    ``device`` (None = ``"cuda"``).  ``params`` are copied there, and the
    copy is updated in place.  A rank of a tensor-parallel world trains its
    cut under its group (``distributed.world.TPTrainer``)."""

    def __init__(self, loss_fn: Callable, params: Any, tcfg: TrainerConfig,
                 ocfg: opt_mod.AdamWConfig, loader: SyntheticTokens,
                 injector: FailureInjector | None = None,
                 straggler_log: list | None = None, device=None):
        self.device = registry.resolve_device(device)
        self.loss_fn = loss_fn
        self.tcfg = tcfg
        self.ocfg = ocfg
        self.loader = loader
        self.injector = injector
        self.straggler_log = straggler_log if straggler_log is not None else []
        self.params = tree_map(lambda t: _own(t, self.device), params)
        self.opt_state = opt_mod.init_state(self.params, ocfg)
        self.step = 0
        self.metrics_history: list[dict] = []
        self._ckpt = ckpt.AsyncCheckpointer(tcfg.ckpt_dir) \
            if tcfg.async_checkpoint else None

    # -- checkpoint/restart ------------------------------------------------

    def state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self):
        if self._ckpt is not None:
            self._ckpt.save(self.step, self.state_tree())
        else:
            ckpt.save(self.tcfg.ckpt_dir, self.step, self.state_tree())

    def try_restore(self) -> bool:
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return False
        tree, step = ckpt.restore(self.tcfg.ckpt_dir, self.state_tree(), device=self.device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = step
        return True

    # -- loop ----------------------------------------------------------------

    def _batch(self, step: int):
        toks, tgts = self.loader.batch(step)
        a = self.tcfg.grad_accum
        b = toks.shape[0] // a
        return {"tokens": torch.from_numpy(np.ascontiguousarray(toks.reshape(a, b, -1))).to(self.device),
                "targets": torch.from_numpy(np.ascontiguousarray(tgts.reshape(a, b, -1))).to(self.device)}

    def run(self, steps: int | None = None) -> list[dict]:
        """Train to ``self.step + steps`` (or ``total_steps``).  A step's
        ``step_time_s`` runs on the host clock from the batch to its metrics
        read back, so it holds the device's work.  An asynchronous save in
        flight is finished before ``run`` returns or raises, so a restart
        after a failure finds it."""
        end = self.step + steps if steps is not None else self.tcfg.total_steps
        try:
            while self.step < end:
                if self.injector is not None:
                    self.injector.maybe_fail(self.step)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = train_step(
                    self.loss_fn, self.params, self.opt_state, self._batch(self.step),
                    self.ocfg)
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                if self.tcfg.step_deadline_s is not None and dt > self.tcfg.step_deadline_s:
                    self.straggler_log.append({"step": self.step, "latency_s": dt})
                self.step += 1
                m["step"] = self.step
                m["step_time_s"] = dt
                self.metrics_history.append(m)
                if self.step % self.tcfg.ckpt_every == 0 or self.step == end:
                    self.save()
        finally:
            if self._ckpt is not None:
                self._ckpt.wait()
        return self.metrics_history


def run_with_restarts(make_trainer: Callable[[], Trainer], total_steps: int,
                      max_restarts: int = 5) -> Trainer:
    """Restart-from-latest supervision loop (the cluster runner analogue)."""
    restarts = 0
    while True:
        trainer = make_trainer()
        trainer.try_restore()
        try:
            remaining = total_steps - trainer.step
            if remaining <= 0:
                return trainer
            trainer.run(remaining)
            return trainer
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
