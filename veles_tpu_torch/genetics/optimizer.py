"""GeneticsOptimizer unit + OptimizationWorkflow.

Port of ``veles_tpu/genetics/optimizer.py``: the optimizer evolves a
Population; each chromosome's evaluation patches the config tree and
runs the model workflow end to end; the job methods serve chromosomes
as jobs (a job = a chromosome, the update = its fitness). With
``sched_tenant=`` each evaluation is one quantum of a shared device
(``veles_tpu_torch.sched``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from veles_tpu_torch.genetics.core import (Chromosome, Population,
                                     scan_config_ranges, set_config_path)
from veles_tpu_torch.config import root
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import IResultProvider, NoMoreJobs, Workflow


def default_evaluator(model_factory: Callable[[], Any],
                      device=None) -> Callable[[Dict[str, Any]], float]:
    """Build the standard fitness function: patch config, construct and
    train the model workflow, return -validation_error (higher=fitter).
    """

    def evaluate(config_values: Dict[str, Any]) -> float:
        for path, value in config_values.items():
            set_config_path(path, value)
        workflow = model_factory()
        workflow.thread_pool = None
        workflow.initialize(device=device)
        workflow.run()
        return -float(workflow.decision.min_validation_error)

    return evaluate


class GeneticsOptimizer(Unit, IResultProvider):
    """Evolves the population one generation per run() pass.

    kwargs: ``evaluate`` (fitness callable), ``size``, ``generations``,
    ``tuneables`` (explicit list) or ``config_root`` (scan for Range
    markers under this config subtree), ``encoding`` ("real" default,
    or the reference's "gray" bitstring operators).
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.evaluate: Callable = kwargs.pop("evaluate")
        size = kwargs.pop("size", 20)
        self.generations: int = kwargs.pop("generations", 10)
        tuneables = kwargs.pop("tuneables", None)
        config_node = kwargs.pop("config_root", None)
        encoding = kwargs.pop("encoding", "real")
        sched_tenant = kwargs.pop("sched_tenant", None)
        super().__init__(workflow, **kwargs)
        # Trailing underscore: a live scheduler handle must stay out
        # of snapshots/checksums (Pickleable drops *_ attributes; a
        # restored optimizer re-registers if it wants tenancy back).
        # Deliberately NOT the unit-level `sched_tenant_` marker: that
        # would make Unit's execution path wrap the WHOLE run() — an
        # entire generation — in one outer quantum, turning every
        # per-chromosome quantum below into a reentrant no-op and
        # holding the pool for minutes instead of one evaluation.
        self._sched_tenant_ = sched_tenant
        if tuneables is None:
            tuneables = scan_config_ranges(
                config_node if config_node is not None else root)
        self.population = Population(tuneables, size=size,
                                     encoding=encoding)
        self.complete = Bool(False, name="genetics_complete")

    def _evaluate(self, config_values: Dict[str, Any]) -> float:
        """One chromosome evaluation = one scheduler quantum when the
        optimizer is a tenant of a shared device pool (the GA's
        natural preemption boundary, veles_tpu_torch.sched); unscheduled
        otherwise."""
        tenant = getattr(self, "_sched_tenant_", None)
        if tenant is None:
            return self.evaluate(config_values)
        with tenant.quantum():
            return self.evaluate(config_values)

    def run(self) -> None:
        if self.is_slave:
            # one chromosome per job (do_job -> run -> result)
            data = self._job_
            self._result_ = {
                "index": data["index"],
                "generation": data["generation"],
                "fitness": self._evaluate(
                    Chromosome(data["genes"]).config_values(
                        self.population.tuneables))}
            return
        for chromo in self.population.unevaluated:
            chromo.fitness = self._evaluate(
                chromo.config_values(self.population.tuneables))
        self._after_generation()

    def _after_generation(self) -> None:
        pop = self.population
        best = max(c.fitness for c in pop.chromosomes)
        self.info("generation %d: best fitness %.4f", pop.generation,
                  best)
        pop.next_generation()
        self.complete <<= pop.generation >= self.generations

    @property
    def best(self) -> Optional[Chromosome]:
        return self.population.best

    @property
    def best_config(self) -> Dict[str, Any]:
        if self.population.best is None:
            return {}
        return self.population.best.config_values(
            self.population.tuneables)

    def get_metric_names(self):
        return {"best_fitness", "best_config", "generations"}

    def get_metric_values(self):
        return {"best_fitness": self.population.best.fitness
                if self.population.best else None,
                "best_config": self.best_config,
                "generations": self.population.generation}

    # -- distributed: a job is a chromosome --------------------------------
    # (reference: optimization_workflow distributes chromosomes exactly
    # like minibatches, veles/genetics/optimization_workflow.py)
    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._outstanding_: Dict[Any, List[int]] = {}
        self._job_ = None
        self._result_ = None

    def generate_data_for_slave(self, slave=None):
        if bool(self.complete):
            raise NoMoreJobs()
        todo = [i for i, c in enumerate(self.population.chromosomes)
                if c.fitness is None and
                not any(i in v for v in self._outstanding_.values())]
        if not todo:
            self.has_data_for_slave = False
            return False
        idx = todo[0]
        self._outstanding_.setdefault(slave, []).append(idx)
        chromo = self.population.chromosomes[idx]
        self.has_data_for_slave = len(todo) > 1
        return {"index": idx, "genes": chromo.genes,
                "generation": self.population.generation}

    def apply_data_from_master(self, data) -> None:
        self._job_ = data

    def generate_data_for_master(self):
        return self._result_

    def apply_data_from_slave(self, data, slave=None) -> None:
        if data["generation"] != self.population.generation:
            return  # stale result from before a drop/regeneration
        idx = data["index"]
        self.population.chromosomes[idx].fitness = data["fitness"]
        if slave in self._outstanding_ and \
                idx in self._outstanding_[slave]:
            self._outstanding_[slave].remove(idx)
        if not self.population.unevaluated:
            self._after_generation()
        # Stay "ready" when complete: the next generate call must reach
        # this unit so it can raise NoMoreJobs and end the job stream.
        self.has_data_for_slave = bool(self.complete) or \
            bool(self.population.unevaluated)

    def retract_data_for_slave(self, slave=None) -> None:
        """Take back the chromosome recorded by an aborted
        generate_data_for_slave call (a later unit raised NoMoreJobs
        or postponed): newest outstanding entry only — older entries
        belong to jobs genuinely in flight."""
        outstanding = self._outstanding_.get(slave)
        if outstanding:
            outstanding.pop()
            if not outstanding:
                del self._outstanding_[slave]
            self.has_data_for_slave = True

    def requeue_one_for_slave(self, slave=None) -> None:
        """Relay retract: ONE of this slave's jobs died downstream,
        but value-keyed bookkeeping cannot tell WHICH index that was
        — popping a guessed entry could strand the dead index as
        outstanding-forever (a livelock: never issuable, never
        scored). Requeue the slave's whole outstanding set instead
        (the drop_slave discipline): applies are idempotent (fitness
        keyed by index, stale generations ignored), so a still-alive
        duplicate recomputes harmlessly while the dead index becomes
        issuable again."""
        self.drop_slave(slave)

    def drop_slave(self, slave=None) -> None:
        dropped = self._outstanding_.pop(slave, [])
        if dropped:
            self.has_data_for_slave = True
            self.warning("worker %r dropped; chromosomes %s requeued",
                         slave, dropped)


class OptimizationWorkflow(Workflow):
    """Repeater -> GeneticsOptimizer -> EndPoint (gated on complete)
    (reference: veles/genetics/optimization_workflow.py)."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        optimizer_kwargs = {
            k: kwargs.pop(k) for k in
            ("evaluate", "size", "generations", "tuneables",
             "config_root", "sched_tenant") if k in kwargs}
        super().__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        self.optimizer = GeneticsOptimizer(self, **optimizer_kwargs)
        self.optimizer.link_from(self.repeater)
        self.repeater.link_from(self.optimizer)
        # Block the cycle the moment optimization completes, so a pool
        # thread can't race an extra generation past the end gate.
        self.repeater.gate_block = self.optimizer.complete
        self.end_point.link_from(self.optimizer)
        self.end_point.gate_block = ~self.optimizer.complete
        self._slave_rewired = False

    def initialize(self, device=None, **kwargs: Any) -> None:
        if self.is_slave and not self._slave_rewired:
            _ = self.checksum
            self.repeater.unlink_from(self.optimizer)
            self.end_point.gate_block <<= False
            self._slave_rewired = True
        super().initialize(device=device, **kwargs)
