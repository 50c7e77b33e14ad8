"""Fault-tolerant training loop: checkpoint/restart, preemption survival
(the port of ``repro/training/trainer.py``).

All state that matters (parameters, optimizer state, error-feedback
buffers, the data iterator's step) round-trips through the port's
:class:`~repro_torch.checkpoint.Checkpointer`, and :meth:`Trainer.run` can
be killed at any step and re-invoked: it resumes from the newest
checkpoint exactly (the data pipeline draws from its step alone).
:class:`FailureInjector` simulates preemptions for the tests.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import SyntheticPipeline
from repro_torch.training.optimizer import members
from repro_torch.training.train_step import (StepMetrics, TrainConfig,
                                             TrainState, init_train_state,
                                             make_train_step)


@dataclasses.dataclass
class FailureInjector:
    """Deterministic simulated preemption: raises at given global steps."""

    fail_at_steps: tuple[int, ...] = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"simulated preemption at step {step}")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    keep_n: int = 3


class Trainer:
    """Trains ``model`` (built on the device it trains on) on batches of
    ``data``.  ``losses`` keeps each step's loss and ``metrics`` each
    step's :class:`StepMetrics` as Python floats."""

    def __init__(self, model, tcfg: TrainConfig, data: SyntheticPipeline,
                 cfg: TrainerConfig,
                 failure_injector: Optional[FailureInjector] = None,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.tcfg = tcfg
        self.data = data
        self.cfg = cfg
        self.injector = failure_injector
        self.log = log_fn
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep_n=cfg.keep_n)
        self.step_fn = make_train_step(model, tcfg)
        self.losses: list[float] = []
        self.metrics: list[StepMetrics] = []

    # ------------------------------------------------------------------ run
    def run(self, seed: int = 0) -> TrainState:
        state, start_step = self._init_or_restore(seed)
        self.data.step = start_step          # fast-forward the iterator
        t0 = time.time()
        for step in range(start_step, self.cfg.total_steps):
            if self.injector is not None:
                self.injector.check(step)
            batch = next(self.data)
            state, metrics = self.step_fn(state, batch)
            m = StepMetrics(*(float(x) for x in metrics))
            self.losses.append(m.loss)
            self.metrics.append(m)
            if step % self.cfg.log_every == 0:
                self.log(f"step {step:5d} loss {m.loss:.4f} "
                         f"gnorm {m.grad_norm:.3f} lr {m.lr:.2e} "
                         f"({time.time() - t0:.1f}s)")
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self._save(state, step + 1)
        self.ckpt.wait()
        return state

    # ------------------------------------------------------------ internals
    def _init_or_restore(self, seed: int) -> tuple[TrainState, int]:
        """Fresh weights drawn from a generator seeded with ``seed`` on the
        model's device; then, if a checkpoint landed, its state in their
        place."""
        gen = torch.Generator(device=self.model.device)
        gen.manual_seed(seed)
        self.model.init_weights(gen)
        state = init_train_state(self.model, self.tcfg)
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        restored, extra = self.ckpt.restore(state, step=latest)
        with torch.no_grad():
            for path, leaf in state.params.items():
                for p, r in zip(members(leaf), members(restored.params[path])):
                    p.copy_(r)
        self.log(f"restored checkpoint at step {latest}")
        return TrainState(state.params, restored.opt,
                          restored.ef_residual), int(extra["data_step"])

    def _save(self, state: TrainState, step: int):
        self.ckpt.save(step, state,
                       extra={"data_step": step,
                              "data_state": self.data.state_dict()})


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_restarts: int = 10):
    """Supervisor: re-launch the trainer after (simulated) preemptions."""
    restarts = 0
    while True:
        trainer = make_trainer()
        try:
            return trainer.run(), restarts
        except RuntimeError as e:
            restarts += 1
            trainer.log(f"[supervisor] {e}; restart {restarts}")
            if restarts > max_restarts:
                raise
