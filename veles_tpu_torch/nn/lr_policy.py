"""Learning-rate schedules.

Port of ``veles_tpu/nn/lr_policy.py`` trimmed to the policies and
:func:`make_policy`; the ``LRScheduler`` unit waits for the unit-graph
slice. A policy is a pure function ``lr = policy(base_lr, epoch,
step)``; the fused trainer calls it on the host once per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

Policy = Callable[[float, int, int], float]

# Policies are small dataclass callables (NOT lambdas/closures), so a
# trainer holding one stays picklable.


@dataclasses.dataclass
class constant:
    def __call__(self, base: float, epoch: int, step: int) -> float:
        return base


@dataclasses.dataclass
class step_decay:
    """base * gamma^(epoch // every) — the classic AlexNet /10 drop."""
    gamma: float = 0.1
    every: int = 10

    def __call__(self, base: float, epoch: int, step: int) -> float:
        return base * self.gamma ** (epoch // self.every)


@dataclasses.dataclass
class exponential_decay:
    gamma: float = 0.95

    def __call__(self, base: float, epoch: int, step: int) -> float:
        return base * self.gamma ** epoch


@dataclasses.dataclass
class inverse_decay:
    """base * (1 + gamma*step)^-power (caffe 'inv'; step =
    minibatches)."""
    gamma: float = 1e-4
    power: float = 0.75

    def __call__(self, base: float, epoch: int, step: int) -> float:
        return base * (1.0 + self.gamma * step) ** -self.power


@dataclasses.dataclass
class warmup_cosine:
    """Linear warmup then cosine to ``floor`` x base."""
    warmup_epochs: int
    total_epochs: int
    floor: float = 0.0

    def __call__(self, base: float, epoch: int, step: int) -> float:
        if self.warmup_epochs and epoch < self.warmup_epochs:
            return base * (epoch + 1) / self.warmup_epochs
        span = max(self.total_epochs - self.warmup_epochs, 1)
        t = min(max(epoch - self.warmup_epochs, 0) / span, 1.0)
        return base * (self.floor + (1 - self.floor) *
                       0.5 * (1 + math.cos(math.pi * t)))


POLICIES: Dict[str, Callable[..., Policy]] = {
    "constant": constant,
    "step": step_decay,
    "exp": exponential_decay,
    "inv": inverse_decay,
    "warmup_cosine": warmup_cosine,
}


def make_policy(spec) -> Policy:
    """``None`` | callable | name | {"type": name, **kwargs}."""
    if spec is None:
        return constant()
    if callable(spec):
        return spec
    if isinstance(spec, str):
        return POLICIES[spec]()
    spec = dict(spec)
    return POLICIES[spec.pop("type")](**spec)
