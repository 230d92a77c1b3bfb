"""Fault-tolerant training runtime.

What it does, as the JAX package's ``runtime/trainer.py`` does:
  * checkpoint/restart: an asynchronous checkpoint every ``ckpt_every``
    steps; on any step failure the loop restores the latest checkpoint and
    resumes (the transient-node-failure model).  Repeated failures back off
    and, past ``max_retries``, re-raise.
  * preemption: SIGTERM (or :meth:`Trainer.request_preempt`) sets a flag;
    the loop checkpoints at the next step boundary and exits.
  * straggler watchdog: the wall time of each step is tracked with an EMA;
    a step slower than ``straggler_factor`` x EMA fires a callback.
  * elastic restart: the checkpoint is restored onto the state the new run
    built (its dtypes, its device; see ``repro_torch.ckpt``).

Two departures from the reference: after a failure the loop waits for an
asynchronous save still being written before it picks the checkpoint to
restore (the reference may restore the one before it), and the SIGTERM
handler lives only as long as :meth:`Trainer.run`.

``state`` is any tree of tensors the checkpoint manager takes, e.g.
``(params, AdamState)``.  ``float(loss)`` is the only synchronization a
step makes.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from repro_torch.bridge import to_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.device import resolve_device


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = field(default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                                               "repro_ckpt"))
    keep: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0
    ema_alpha: float = 0.1


@dataclass
class TrainerReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    preempted: bool = False
    losses: List[float] = field(default_factory=list)


class Trainer:
    """Drives ``step_fn(state, batch) -> (state, loss)`` with ``batch =
    batch_fn(step)`` on ``device`` (the CUDA device by default; raises
    without one): :meth:`run` moves the state there first."""

    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 batch_fn: Callable[[int], Any],
                 straggler_cb: Optional[Callable[[int, float, float], None]] = None,
                 *, device=None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.straggler_cb = straggler_cb
        self._preempt = False
        self._ema: Optional[float] = None

    def _install_signal_handler(self):
        """SIGTERM -> preempt for the length of :meth:`run`; returns the
        handler it replaced (None off the main thread, where none is set)."""
        try:
            return signal.signal(signal.SIGTERM,
                                 lambda *_: setattr(self, "_preempt", True))
        except ValueError:
            return None

    def request_preempt(self):
        self._preempt = True

    def run(self, state: Any, start_step: int = 0,
            fail_injector: Optional[Callable[[int], None]] = None
            ) -> tuple[Any, TrainerReport]:
        previous = self._install_signal_handler()
        try:
            return self._run(to_device(state, self.device), start_step, fail_injector)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self, state, start_step, fail_injector):
        report = TrainerReport()
        step = start_step
        retries = 0

        # resume from the latest checkpoint if there is one
        latest = self.ckpt.latest_step()
        if latest is not None and latest >= start_step:
            state = self.ckpt.restore(latest, state)
            step = latest                # restoring at boot is not a failure

        while step < self.cfg.total_steps:
            if self._preempt:
                self.ckpt.wait()
                self.ckpt.save(step, state, blocking=True)
                report.preempted = True
                break
            t0 = time.perf_counter()
            try:
                if fail_injector is not None:
                    fail_injector(step)
                batch = self.batch_fn(step)
                state, loss = self.step_fn(state, batch)
                loss = float(loss)
            except Exception:
                # the node-failure model: restore and retry from the last checkpoint
                retries += 1
                report.restarts += 1
                if retries > self.cfg.max_retries:
                    raise
                self.ckpt.wait()         # a save in flight is the newest checkpoint
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state = self.ckpt.restore(latest, state)
                    step = latest
                time.sleep(0.01 * 2 ** retries)  # backoff
                continue
            retries = 0
            dt = time.perf_counter() - t0
            if self._ema is not None and dt > self.cfg.straggler_factor * self._ema:
                report.stragglers += 1
                if self.straggler_cb:
                    self.straggler_cb(step, dt, self._ema)
            self._ema = dt if self._ema is None else \
                (1 - self.cfg.ema_alpha) * self._ema + self.cfg.ema_alpha * dt
            report.losses.append(loss)
            step += 1
            report.steps_run += 1
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, state, blocking=False)
        self.ckpt.wait()
        return state, report
