"""Fault-tolerant training loop, torch port of
``src/repro/train/trainer.py``.

* auto-resume from the latest committed checkpoint (atomic commits: a
  crash mid-save never corrupts the resume point);
* SIGTERM/SIGINT hook: one final blocking checkpoint before the loop
  ends (preemption);
* asynchronous checkpoints every ``ckpt_every`` steps (the loop waits
  only for the device-to-host copy);
* deterministic step-indexed data: a restart replays the exact batch
  sequence with no pipeline state;
* straggler monitor: an EWMA of the step's wall time; steps slower than
  ``straggler_factor`` x EWMA are recorded with their step index.

A step's wall time ends in ``torch.cuda.synchronize()`` when its loss
lives on the card (the reference's ``jax.block_until_ready``); losses
are read back to the host only at ``log_every`` (the reference's
``float``).  Both stay outside the step: a graphed step
(``train.GraphedTrainStep``, the launcher's on the card) replays the
step alone and returns fresh tensors, so ``self.state`` may be
checkpointed asynchronously and restored into as with the eager step.
"""
from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import Checkpointer

logger = logging.getLogger("repro_torch.trainer")

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    ckpt_every: int = 100
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 2.5
    ewma_alpha: float = 0.1
    eval_every: int = 0


class Trainer:
    def __init__(
        self,
        step_fn: Callable,
        state: Dict[str, Any],
        batch_fn: Callable[[int], Dict[str, Any]],
        cfg: TrainerConfig,
        *,
        eval_fn: Optional[Callable] = None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        self._preempted = False
        self._ewma = None
        self.metrics_log: list = []
        self.straggler_events: list = []

    # -- fault tolerance hooks -------------------------------------------------

    def _install_signal_handlers(self) -> Dict[int, Any]:
        """Route SIGTERM/SIGINT to a preemption flag; returns the handlers
        they replace, for ``_restore_signal_handlers``."""
        def handler(signum, frame):
            logger.warning("preemption signal %s: checkpointing and exiting", signum)
            self._preempted = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread (tests)
        return previous

    @staticmethod
    def _restore_signal_handlers(previous: Dict[int, Any]):
        for sig, h in previous.items():
            # None: a handler not set from Python, which cannot be put back
            signal.signal(sig, signal.SIG_DFL if h is None else h)

    def resume_if_available(self) -> int:
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        self.state = self.ckpt.restore(latest, target=self.state)
        logger.info("resumed from checkpoint step %d", latest)
        return latest

    # -- loop ----------------------------------------------------------------

    def _monitor_step_time(self, step: int, dt: float):
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma and step > 3:
            self.straggler_events.append({"step": step, "dt": dt, "ewma": self._ewma})
            logger.warning(
                "straggler: step %d took %.3fs (EWMA %.3fs, factor %.1f)",
                step, dt, self._ewma, dt / self._ewma,
            )
        a = self.cfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt

    def run(self) -> Dict[str, Any]:
        """Train to ``total_steps``; the process's own SIGTERM/SIGINT
        handlers are back in place when it returns or raises."""
        previous = self._install_signal_handlers()
        try:
            return self._run()
        finally:
            self._restore_signal_handlers(previous)

    def _run(self) -> Dict[str, Any]:
        start = self.resume_if_available()
        step = start
        for step in range(start, self.cfg.total_steps):
            if self._preempted:
                break
            t0 = time.time()
            batch = self.batch_fn(step)
            self.state, metrics = self.step_fn(self.state, batch)
            if metrics["total_loss"].is_cuda:
                torch.cuda.synchronize(metrics["total_loss"].device)
            dt = time.time() - t0
            self._monitor_step_time(step, dt)

            if self.cfg.log_every and step % self.cfg.log_every == 0:
                row = {k: float(v) for k, v in metrics.items()}
                row["step"] = step
                row["dt"] = dt
                self.metrics_log.append(row)
                logger.info("step %d loss=%.4f dt=%.3fs", step, row["total_loss"], dt)

            if self.cfg.ckpt_every and (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step + 1, self.state)

            if self.cfg.eval_every and self.eval_fn and (step + 1) % self.cfg.eval_every == 0:
                self.eval_fn(self.state, step + 1)

        final_step = step + (0 if self._preempted else 1)
        # drain any in-flight async save of this step before the final
        # blocking one, or both writers race on the same .tmp dir
        self.ckpt.wait()
        if self.ckpt.latest_step() != final_step:
            self.ckpt.save(final_step, self.state, blocking=True)
        self.ckpt.wait()      # every rank of a sharded run sees it committed
        return {
            "final_step": final_step,
            "preempted": self._preempted,
            "stragglers": self.straggler_events,
            "metrics": self.metrics_log,
        }
