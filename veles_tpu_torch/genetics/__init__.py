"""Genetic-algorithm hyperparameter optimization.

Port of ``veles_tpu/genetics/``: ``Range`` markers in the config tree,
``Chromosome`` and ``Population`` with roulette selection, crossover
and mutation (real-valued genes by default, the reference's Gray-coded
bitstrings with ``encoding="gray"``), and an ``OptimizationWorkflow``
that evaluates chromosomes, each a full model training run, in-process
or as jobs of the job channel. Draws come from the port's ``prng``
streams, as the reference draws them, so a seeded population evolves
as the reference's does.
"""

from veles_tpu_torch.genetics.core import (  # noqa: F401
    Chromosome, Population, Range, Tuneable, scan_config_ranges,
    set_config_path)
from veles_tpu_torch.genetics.optimizer import (  # noqa: F401
    GeneticsOptimizer, OptimizationWorkflow, default_evaluator)
