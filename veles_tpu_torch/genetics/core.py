"""GA primitives: tunable ranges, chromosomes, populations.

Port of ``veles_tpu/genetics/core.py``. Genes are real values in
[min, max] (log-scaled when the range spans two decades or more) with
arithmetic/uniform crossover and gaussian/reset mutation by default;
``Population(..., encoding="gray")`` selects Gray-coded bitstring
operators instead (bit-slice crossover, bit-flip mutation over
GRAY_BITS quantized genes).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

from veles_tpu_torch import prng
from veles_tpu_torch.config import Config, root


class Range:
    """A tunable leaf marker placed in the config tree
    (reference: genetics/config.py Range)."""

    def __init__(self, default: Any, min_value: float,
                 max_value: float) -> None:
        self.default = default
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    @property
    def is_integer(self) -> bool:
        return isinstance(self.default, int) and \
            not isinstance(self.default, bool)

    def __repr__(self) -> str:
        return "Range(%r, %r, %r)" % (self.default, self.min_value,
                                      self.max_value)


class Tuneable:
    """A named tunable parameter resolved from a config path."""

    def __init__(self, path: str, rng: Range) -> None:
        self.path = path
        self.range = rng
        # log-scale genes whose range spans >= 2 decades (lr, wd, ...)
        self.log = (rng.min_value > 0 and
                    rng.max_value / rng.min_value >= 100)

    def sample(self, rand) -> float:
        return self.from_unit(rand.random_sample())

    def clip(self, value: float) -> Any:
        value = min(max(value, self.range.min_value),
                    self.range.max_value)
        return int(round(value)) if self.range.is_integer else value

    # -- unit-interval mapping (the gray encoding works on [0, 1]) ---------
    def to_unit(self, value: float) -> float:
        lo, hi = self.range.min_value, self.range.max_value
        value = min(max(value, lo), hi)
        if self.log:
            return (math.log(value) - math.log(lo)) / \
                (math.log(hi) - math.log(lo))
        return (value - lo) / (hi - lo) if hi > lo else 0.0

    def from_unit(self, u: float) -> float:
        lo, hi = self.range.min_value, self.range.max_value
        u = min(max(u, 0.0), 1.0)
        if self.log:
            return math.exp(u * (math.log(hi) - math.log(lo)) +
                            math.log(lo))
        return lo + u * (hi - lo)

    def __repr__(self) -> str:
        return "<Tuneable %s %r>" % (self.path, self.range)


def scan_config_ranges(node: Config, prefix: str = "root"
                       ) -> List[Tuneable]:
    """Collect Range leaves from a config subtree
    (reference: genetics fetches Range markers from the tree)."""
    out: List[Tuneable] = []
    for key, value in node.__dict__.items():
        if key.startswith("_") and key.endswith("_"):
            continue
        path = "%s.%s" % (prefix, key)
        if isinstance(value, Range):
            out.append(Tuneable(path, value))
        elif isinstance(value, Config):
            out.extend(scan_config_ranges(value, path))
    return out


def set_config_path(path: str, value: Any) -> None:
    parts = path.split(".")
    if parts[0] == "root":
        parts = parts[1:]
    node = root
    for p in parts[:-1]:
        node = getattr(node, p)
    setattr(node, parts[-1], value)


class Chromosome:
    """One candidate: genes aligned with a Tuneable list."""

    def __init__(self, genes: List[float]) -> None:
        self.genes = list(genes)
        self.fitness: Optional[float] = None

    def config_values(self, tuneables: Sequence[Tuneable]
                      ) -> Dict[str, Any]:
        return {t.path: t.clip(g)
                for t, g in zip(tuneables, self.genes)}

    def __repr__(self) -> str:
        return "<Chromosome %s fit=%s>" % (
            ["%.4g" % g for g in self.genes], self.fitness)


class Population:
    """Evolving population with roulette selection, crossover and
    mutation (reference: veles/genetics/core.py Population)."""

    #: bits per gene in the "gray" encoding
    GRAY_BITS = 16

    def __init__(self, tuneables: Sequence[Tuneable], size: int = 20,
                 crossover_rate: float = 0.9,
                 mutation_rate: float = 0.15,
                 elite: int = 2,
                 encoding: str = "real",
                 rand=None) -> None:
        if not tuneables:
            raise ValueError("nothing to optimize: no Range markers")
        if encoding not in ("real", "gray"):
            raise ValueError("encoding must be 'real' or 'gray'")
        self.tuneables = list(tuneables)
        self.size = size
        self.crossover_rate = crossover_rate
        self.mutation_rate = mutation_rate
        self.elite = elite
        #: "real": arithmetic/uniform crossover + gaussian/reset
        #: mutation on float genes; "gray": the reference's
        #: gray-coded bitstring operators (bit-slice crossover,
        #: bit-flip mutation — veles/genetics/core.py:133-830), with
        #: genes quantized to GRAY_BITS over each tunable's range.
        self.encoding = encoding
        self.rand = rand or prng.get("genetics")
        self.generation = 0
        self.chromosomes: List[Chromosome] = [
            Chromosome([t.sample(self.rand) for t in self.tuneables])
            for _ in range(size)]
        self.best: Optional[Chromosome] = None

    # -- gray encoding helpers ---------------------------------------------
    def _encode(self, t: Tuneable, value: float) -> int:
        """value -> gray-coded GRAY_BITS integer over t's range."""
        q = int(round(t.to_unit(value) * ((1 << self.GRAY_BITS) - 1)))
        return q ^ (q >> 1)

    def _decode(self, t: Tuneable, gray: int) -> float:
        q = gray
        shift = 1
        while shift < self.GRAY_BITS:
            q ^= q >> shift
            shift <<= 1
        return t.from_unit(q / ((1 << self.GRAY_BITS) - 1))

    # -- GA operators ------------------------------------------------------
    def _roulette(self, scored: List[Chromosome]) -> Chromosome:
        total = sum(max(c.fitness, 1e-12) for c in scored)
        pick = self.rand.random_sample() * total
        acc = 0.0
        for c in scored:
            acc += max(c.fitness, 1e-12)
            if acc >= pick:
                return c
        return scored[-1]

    def _crossover(self, a: Chromosome, b: Chromosome) -> Chromosome:
        if self.encoding == "gray":
            return self._crossover_gray(a, b)
        genes = []
        for ga, gb in zip(a.genes, b.genes):
            r = self.rand.random_sample()
            if r < 0.5:     # uniform: pick one parent
                genes.append(ga if self.rand.random_sample() < 0.5
                             else gb)
            else:           # arithmetic blend
                w = self.rand.random_sample()
                genes.append(w * ga + (1 - w) * gb)
        return Chromosome(genes)

    def _crossover_gray(self, a: Chromosome, b: Chromosome) -> Chromosome:
        """Per-gene single-point BIT crossover on the gray strings —
        adjacent gray codes differ by one bit, so slicing parents'
        strings explores nearby values without the large decoding
        jumps plain binary slicing causes."""
        genes = []
        bits = self.GRAY_BITS
        for t, ga, gb in zip(self.tuneables, a.genes, b.genes):
            xa, xb = self._encode(t, ga), self._encode(t, gb)
            point = int(self.rand.random_sample() * (bits - 1)) + 1
            mask = (1 << point) - 1
            child = (xa & ~mask) | (xb & mask)
            genes.append(self._decode(t, child))
        return Chromosome(genes)

    def _mutate(self, c: Chromosome) -> None:
        if self.encoding == "gray":
            # reference-style bit flips: each gene flips one random
            # bit with mutation_rate (a gray bit flip is a bounded
            # move in value space, large only for high-order bits)
            for i, t in enumerate(self.tuneables):
                if self.rand.random_sample() >= self.mutation_rate:
                    continue
                bit = int(self.rand.random_sample() * self.GRAY_BITS)
                c.genes[i] = self._decode(
                    t, self._encode(t, c.genes[i]) ^ (1 << bit))
            return
        for i, t in enumerate(self.tuneables):
            if self.rand.random_sample() >= self.mutation_rate:
                continue
            if self.rand.random_sample() < 0.2:
                c.genes[i] = t.sample(self.rand)  # reset mutation
            else:
                span = t.range.max_value - t.range.min_value
                c.genes[i] += (self.rand.random_sample() - 0.5) * \
                    0.2 * span
                c.genes[i] = min(max(c.genes[i], t.range.min_value),
                                 t.range.max_value)

    def next_generation(self) -> None:
        """Breed from the evaluated population (all fitness set)."""
        scored = sorted(self.chromosomes,
                        key=lambda c: c.fitness, reverse=True)
        if self.best is None or scored[0].fitness > self.best.fitness:
            self.best = Chromosome(scored[0].genes)
            self.best.fitness = scored[0].fitness
        new: List[Chromosome] = []
        for c in scored[:self.elite]:     # elitism
            keep = Chromosome(c.genes)
            keep.fitness = c.fitness
            new.append(keep)
        while len(new) < self.size:
            if self.rand.random_sample() < self.crossover_rate:
                child = self._crossover(self._roulette(scored),
                                        self._roulette(scored))
            else:
                child = Chromosome(list(self._roulette(scored).genes))
            self._mutate(child)
            new.append(child)
        self.chromosomes = new
        self.generation += 1

    @property
    def unevaluated(self) -> List[Chromosome]:
        return [c for c in self.chromosomes if c.fitness is None]
