"""Learning-rate schedules and the unit that applies them.

Port of ``veles_tpu/nn/lr_policy.py``: the policies, :func:`make_policy`
and the ``LRScheduler`` unit. A policy is a pure function ``lr =
policy(base_lr, epoch, step)``; the fused trainer calls it on the host
once per step, the unit at each epoch boundary of a unit graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

from veles_tpu_torch.units import Unit

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


class LRScheduler(Unit):
    """Applies a policy to every GD unit's learning_rate: once at
    initialize (so warmup governs epoch 0) and then at each epoch
    boundary, AFTER the backward chain (link_from(gds[-1]) — the
    boundary minibatch's gds must not race the mutation). ``step``
    passed to the policy is the loader's global minibatch counter,
    matching the fused trainer's semantics. The StandardWorkflow
    wires all of this when given ``lr_policy``.
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.policy: Policy = make_policy(kwargs.pop("policy", None))
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        self.gds = []
        self.epoch_number: Optional[int] = None
        # global minibatch counter (link from the loader) so 'step'
        # means the same thing here and in the fused trainer
        self.minibatches_served = 0
        self.current_lr: Optional[float] = None
        # keyed by position in self.gds — stable across pickle/resume
        # (id() keys go stale after unpickling and would re-record the
        # already-decayed lr as the base: double decay)
        self._base_lrs: Dict[int, tuple] = {}
        self.demand("epoch_number")

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        for idx, gd in enumerate(self.gds):
            if hasattr(gd, "learning_rate") and idx not in self._base_lrs:
                self._base_lrs[idx] = (
                    float(gd.learning_rate),
                    float(getattr(gd, "learning_rate_bias",
                                  gd.learning_rate)))
        # Apply immediately: warmup policies must govern epoch 0 too,
        # not only from the first epoch boundary onward.
        self._apply()
        return None

    @property
    def base_lr(self) -> Optional[float]:
        """The UNSCHEDULED base lr of the first parametric gd — what a
        consumer re-running the policy itself (train_fused) must use;
        gd.learning_rate already has the policy applied."""
        if not self._base_lrs:
            return None
        return self._base_lrs[min(self._base_lrs)][0]

    def rebase(self, learning_rate: float,
               learning_rate_bias: Optional[float] = None) -> None:
        """Replace every recorded base lr (resume-override path): the
        schedule continues from the NEW base instead of clobbering the
        override at the next apply."""
        bias = learning_rate if learning_rate_bias is None \
            else learning_rate_bias
        for idx in list(self._base_lrs):
            self._base_lrs[idx] = (float(learning_rate), float(bias))

    def _apply(self) -> None:
        epoch = int(self.epoch_number or 0)
        step = int(self.minibatches_served or 0)
        for idx, gd in enumerate(self.gds):
            bases = self._base_lrs.get(idx)
            if bases is None:
                continue
            base_w, base_b = bases
            # the policy applies to each base independently, so a
            # configured weight/bias lr ratio (e.g. 2x bias) survives
            lr = float(self.policy(base_w, epoch, step))
            gd.learning_rate = lr
            if hasattr(gd, "learning_rate_bias"):
                gd.learning_rate_bias = float(
                    self.policy(base_b, epoch, step))
            self.current_lr = lr

    def run(self) -> None:
        self._apply()
