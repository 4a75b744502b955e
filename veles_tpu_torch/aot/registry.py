"""THE steady-state computation registry: every capture site of the
port, on canonical small configs.

Port of ``veles_tpu/aot/registry.py``, under the reference's entry
names. Where the reference enumerates its jitted computations, the port
enumerates the sites that capture a CUDA graph (or, where a site runs
eagerly, record its dispatch) and hand the plan its record
(``aot/warmup.py``): what ships as ``aot/`` records, what a warm start
captures before traffic, what the memory plan sizes
(``analysis.memplan``) and what the golden-graph gate fingerprints
(``analysis.jaxpr_audit``).

Each :class:`Computation` names its ``site`` (``file:Class.method``,
the function holding the capture or the eager dispatch), its plan
entry names (``entry``, a prefix for families keyed by shape), whether
it is ``captured`` into a CUDA graph on the card, the tensors it
updates in place (``donation``, the counterpart of ``donate_argnums``;
``analysis.memplan`` checks that the site really writes them in place),
and its dtype-policy allowance (``allowed_f32_upcasts``, the wide
bf16->f32 upcasts its dispatched graph may hold, each named in
``notes``; ``analysis.jaxpr_audit`` rule VJ005).
``build(device)`` makes the site's owner on a canonical config and
returns ``(fn, args)``: ``fn(*args)`` runs one call of the site through
its public entry point.

- ``engine_forward``: one ``InferenceEngine`` bucket's forward
  (captured per bucket);
- ``generative_prefill``: a slab prefill bucket (eager in the port:
  listed, not captured; no plan entry);
- ``generative_decode``: the ONE slab decode step (captured);
- ``paged_prefill``: a paged prefill bucket (eager, as above);
- ``paged_decode``: the paged decode round (captured, greedy and
  sampled);
- ``paged_verify`` / ``paged_propose``: the speculative round, which the
  port captures as one body (propose + verify);
- ``paged_copy``: the copy-on-write page copy (eager);
- ``lm_step_many``: ``TransformerTrainer``'s step, captured per token
  shape and replayed K times a ``step_many``;
- ``mlp_step_many``: ``FusedClassifierTrainer.step_many``, its step
  captured per batch shape and replayed K times a dispatch (the
  dropout key, learning rate and rates read from device scalars);
- ``loader_step_many``: ``make_loader_step``'s gather + normalize +
  train dispatch, captured per window kind (full, short) and replayed
  K times.
"""

from __future__ import annotations

from typing import Callable, List, Tuple


class Computation:
    """One registry entry (see the module docstring)."""

    __slots__ = ("name", "build", "site", "entry", "captured",
                 "donation", "allowed_f32_upcasts", "notes")

    def __init__(self, name: str, build: Callable[..., Tuple[Callable,
                                                             tuple]],
                 site: str, entry: Tuple[str, ...], captured: bool,
                 donation: Tuple[str, ...] = (),
                 allowed_f32_upcasts: int = 0, notes: str = "") -> None:
        self.name = name
        self.build = build
        self.site = site
        self.entry = tuple(entry)
        self.captured = bool(captured)
        self.donation = tuple(donation)
        self.allowed_f32_upcasts = int(allowed_f32_upcasts)
        self.notes = notes

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<Computation %s at %s>" % (self.name, self.site)


# -- canonical fixtures ------------------------------------------------------

#: fused-classifier canonical stack (fan-in 64 -> 128 -> 10)
_MLP_SPECS = (("fc", "tanh"), ("fc", "softmax"))


def _mlp_params():
    import numpy as np
    rng = np.random.default_rng(0)

    def dense(fan_in, shape):
        return (rng.standard_normal(shape) /
                np.sqrt(fan_in)).astype(np.float32)

    return [{"w": dense(64, (64, 128)), "b": np.zeros(128, np.float32)},
            {"w": dense(128, (128, 10)), "b": np.zeros(10, np.float32)}]


def _lm_config():
    from veles_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab=256, embed=128, heads=4, layers=2,
                             seq_len=128, compute="bfloat16")


def _draft_config():
    from veles_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(vocab=256, embed=64, heads=2, layers=1,
                             seq_len=128, compute="bfloat16")


def _prompts(n: int, length: int):
    import numpy as np
    return [np.full(length, 1 + i, np.int32) for i in range(n)]


def _build_engine_forward(device="cpu"):
    import numpy as np

    from veles_tpu_torch.serve.engine import InferenceEngine
    engine = InferenceEngine.from_specs(_MLP_SPECS, _mlp_params(),
                                        device=device)
    return engine.apply, (np.zeros((64, 64), np.float32),)


def _generative_engine(device):
    from veles_tpu_torch.models.transformer import init_params
    from veles_tpu_torch.serve.engine import GenerativeEngine
    config = _lm_config()
    return GenerativeEngine(config, init_params(config, seed=0),
                            max_slots=4, device=device)


def _build_generative_prefill(device="cpu"):
    engine = _generative_engine(device)

    def prefill(prompts):
        slots, first = engine.admit(prompts)
        for slot in slots:
            engine.release(slot)
        return first

    return prefill, (_prompts(4, 64),)


def _build_generative_decode(device="cpu"):
    engine = _generative_engine(device)
    engine.admit(_prompts(1, 16))
    return engine.decode, ()


def _paged_engine(device, draft: bool = False):
    from veles_tpu_torch.models.transformer import init_params
    from veles_tpu_torch.serve.engine import PagedGenerativeEngine
    config = _lm_config()
    kwargs = {}
    if draft:
        dcfg = _draft_config()
        kwargs = dict(draft_params=init_params(dcfg, seed=1),
                      draft_config=dcfg, draft_tokens=4)
    return PagedGenerativeEngine(config, init_params(config, seed=0),
                                 max_slots=4, page_size=16, device=device,
                                 **kwargs)


def _build_paged_prefill(device="cpu"):
    engine = _paged_engine(device)

    def prefill(prompts):
        slots, first = engine.admit(prompts)
        for slot in slots:
            engine.release(slot)
        return first

    return prefill, (_prompts(4, 64),)


def _build_paged_decode(device="cpu"):
    engine = _paged_engine(device)
    engine.admit(_prompts(1, 16))
    return engine.decode_many, ()


def _build_paged_speculative(device="cpu"):
    engine = _paged_engine(device, draft=True)
    engine.admit(_prompts(1, 16), [{"draft": True}])
    return engine.decode_many, ()


def _build_paged_copy(device="cpu"):
    import numpy as np
    engine = _paged_engine(device)
    ids = np.zeros((1,), np.int32)
    return engine._device_copy, (ids, ids + 1)


def _build_lm_step_many(device="cpu"):
    import numpy as np

    from veles_tpu_torch.models.transformer import TransformerTrainer
    trainer = TransformerTrainer(_lm_config(), device=device)
    return trainer.step_many, (np.zeros((2, 2, 129), np.int32),)


def _mlp_trainer(device):
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    return FusedClassifierTrainer(_MLP_SPECS, _mlp_params(), device=device)


def _build_mlp_step_many(device="cpu"):
    import numpy as np
    trainer = _mlp_trainer(device)
    return trainer.step_many, (np.zeros((2, 8, 64), np.float32),
                               np.zeros((2, 8), np.int64))


def _build_loader_step_many(device="cpu"):
    import numpy as np

    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    rng = np.random.default_rng(0)
    data = rng.standard_normal((64, 64)).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)

    class Canonical(FullBatchLoader):
        def load_data(self):
            self.has_labels = True
            self.original_data = data
            self.original_labels = labels
            self.class_lengths[:] = [0, 0, len(data)]

    loader = Canonical(AcceleratedWorkflow(None, name="canonical"),
                       minibatch_size=8, shuffle_limit=0)
    loader.initialize(device=Device(backend="cpu")
                      if str(device) == "cpu" else Device())
    loader.minibatch_class = TRAIN
    trainer = _mlp_trainer(device)
    return trainer.make_loader_step(loader, steps_per_dispatch=2), ()


#: what the allowances count (``analysis.jaxpr_audit``, VJ005): the
#: CPU run goes through the kernels' plain versions, which lift bf16
#: K/V, queries and scores to f32 copies where the kernels read bf16 in
#: place and accumulate in f32 registers; those copies are named below
#: beside the policy's own f32 islands (layer-norm statistics, the f32
#: master gradients)
_PLAIN_ATTN = "the plain attention's f32 copies"


def canonical_computations() -> List[Computation]:
    """The registry, in a fixed order. ``allowed_f32_upcasts`` values
    are measured on the canonical configs (CPU, plain versions) and
    each one is named; the audit fails on the first graph that exceeds
    its allowance."""
    engine = "serve/engine.py:"
    return [
        Computation(
            "engine_forward", _build_engine_forward,
            engine + "InferenceEngine._graph_for", ("forward/",), True,
            allowed_f32_upcasts=0,
            notes="one captured graph per bucket; eager engines record "
                  "the bucket in _device_apply; f32 throughout (no wide "
                  "upcast)"),
        Computation(
            "generative_prefill", _build_generative_prefill,
            engine + "GenerativeEngine._device_prefill", (), False,
            ("cache", "lengths", "last_tokens"),
            allowed_f32_upcasts=13,
            notes="eager in the port (queued: ROADMAP.md lever 1b); no "
                  "plan entry: warm() runs every bucket before traffic. "
                  "13 wide upcasts: layer-norm inputs [bb, tb, E] (2 a "
                  "block + ln_f = 5), " + _PLAIN_ATTN + " of q/k/v (3 a "
                  "layer = 6) and of the score tiles [bb, H, tb, tb] (1 a "
                  "layer = 2)"),
        Computation(
            "generative_decode", _build_generative_decode,
            engine + "GenerativeEngine._device_decode", ("decode",), True,
            ("cache", "lengths", "last_tokens"),
            allowed_f32_upcasts=4,
            notes="4 wide upcasts, all " + _PLAIN_ATTN + " of each "
                  "layer's K and V slab [slots, S, H, Dh] (K4 reads them "
                  "in place); single-token tensors sit below the wide "
                  "threshold"),
        Computation(
            "paged_prefill", _build_paged_prefill,
            engine + "PagedGenerativeEngine._device_prefill", (), False,
            ("cache", "state"),
            allowed_f32_upcasts=13,
            notes="eager, as generative_prefill, with its 13 upcasts; the "
                  "canonical engine has no draft, so the draft slab is "
                  "not written"),
        Computation(
            "paged_decode", _build_paged_decode,
            engine + "PagedGenerativeEngine._run_round",
            ("decode", "decode/sampled"), True,
            ("cache", "lengths", "tokens", "counters"),
            allowed_f32_upcasts=4,
            notes="4 wide upcasts, all " + _PLAIN_ATTN + " of each "
                  "layer's gathered K and V pages (K5 reads the pages in "
                  "place)"),
        Computation(
            "paged_verify", _build_paged_speculative,
            engine + "PagedGenerativeEngine._run_round",
            ("propose+verify", "propose+verify/sampled"), True,
            ("cache", "draft_cache", "lengths", "tokens", "counters"),
            allowed_f32_upcasts=16,
            notes="one captured body with paged_propose (the same 16): "
                  + _PLAIN_ATTN + " of the draft slab's K and V at each of "
                  "its 5 steps (10), of the target's gathered pages (4) "
                  "and of the verify chunk's scores [slots, H, K+1, S] "
                  "(2)"),
        Computation(
            "paged_propose", _build_paged_speculative,
            engine + "PagedGenerativeEngine._run_round",
            ("propose+verify", "propose+verify/sampled"), True,
            ("draft_cache",),
            allowed_f32_upcasts=16,
            notes="one captured body with paged_verify (its 16 upcasts)"),
        Computation(
            "paged_copy", _build_paged_copy,
            engine + "PagedGenerativeEngine._device_copy", (), False,
            ("cache",), allowed_f32_upcasts=0,
            notes="eager: an indexed copy a COW round; no converts"),
        Computation(
            "lm_step_many", _build_lm_step_many,
            "models/transformer.py:TransformerTrainer._run_step",
            ("lm_step_many/",), True,
            ("params", "opt_m", "opt_v", "step"),
            allowed_f32_upcasts=112,
            notes="2 steps of 56: the bf16 param-cast cotangents "
                  "re-entering the f32 master gradients (qkv, proj, "
                  "mlp_in, mlp_out, embed: 10), layer-norm inputs "
                  "[B, T, E] forward, recompute and backward (16), "
                  + _PLAIN_ATTN + " of q/k/v/o/dO in the blocked forward "
                  "and backward (22) and of the score tiles (8)"),
        Computation(
            "mlp_step_many", _build_mlp_step_many,
            "parallel/fused.py:FusedClassifierTrainer._dispatch",
            ("mlp_step_many/",), True, ("params", "velocity"),
            allowed_f32_upcasts=0,
            notes="captured per batch shape, replayed K times a "
                  "step_many; K8 reads its key from device memory, the "
                  "rates are device scalars; eager on a mesh of more "
                  "than one rank; f32 throughout"),
        Computation(
            "loader_step_many", _build_loader_step_many,
            "parallel/fused.py:FusedClassifierTrainer._dispatch",
            ("loader_step_many/",), True, ("params", "velocity"),
            allowed_f32_upcasts=0,
            notes="as mlp_step_many, one graph for full windows and one "
                  "for a short window, the window's indices copied in "
                  "on the device; the gather adds no f32 island"),
    ]


def entry_names() -> List[str]:
    """Every plan entry name or prefix the registry covers."""
    return sorted({e for c in canonical_computations() for e in c.entry})


__all__ = ["Computation", "canonical_computations", "entry_names"]
