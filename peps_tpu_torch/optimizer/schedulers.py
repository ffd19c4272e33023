"""Learning-rate schedulers (port of ``peps_tpu/optimizer/schedulers.py``).

Each maps (step, energy) to a learning rate on the host; ``Plateau`` keeps
its best energy and patience count across calls, so one instance belongs
to one optimization run.
"""
from __future__ import annotations

import dataclasses
import math


class LearningRateScheduler:
    def __call__(self, step: int, energy: float | None = None) -> float:
        raise NotImplementedError


@dataclasses.dataclass
class Constant(LearningRateScheduler):
    lr: float

    def __call__(self, step, energy=None):
        return self.lr


@dataclasses.dataclass
class ExponentialDecay(LearningRateScheduler):
    lr: float
    decay_rate: float
    decay_steps: int

    def __call__(self, step, energy=None):
        return self.lr * self.decay_rate ** (step / max(1, self.decay_steps))


@dataclasses.dataclass
class StepDecay(LearningRateScheduler):
    lr: float
    factor: float
    step_size: int

    def __call__(self, step, energy=None):
        return self.lr * self.factor ** (step // max(1, self.step_size))


@dataclasses.dataclass
class CosineAnnealing(LearningRateScheduler):
    lr: float
    t_max: int
    lr_min: float = 0.0

    def __call__(self, step, energy=None):
        t = min(step, self.t_max)
        return self.lr_min + 0.5 * (self.lr - self.lr_min) * (
            1 + math.cos(math.pi * t / max(1, self.t_max)))


@dataclasses.dataclass
class Plateau(LearningRateScheduler):
    """Reduce the learning rate by ``factor`` when the energy has not
    improved by ``threshold`` for more than ``patience`` calls."""
    lr: float
    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    lr_min: float = 0.0

    _best: float = dataclasses.field(default=math.inf, init=False)
    _stale: int = dataclasses.field(default=0, init=False)
    _current: float | None = dataclasses.field(default=None, init=False)

    def __call__(self, step, energy=None):
        if self._current is None:
            self._current = self.lr
        if energy is not None:
            if energy < self._best - self.threshold:
                self._best = energy
                self._stale = 0
            else:
                self._stale += 1
                if self._stale > self.patience:
                    self._current = max(self.lr_min,
                                        self._current * self.factor)
                    self._stale = 0
        return self._current
