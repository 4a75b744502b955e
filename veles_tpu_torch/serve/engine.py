"""The serving engines on one CUDA device: the forward plane
:class:`InferenceEngine` (one captured graph per batch bucket), the
slab :class:`GenerativeEngine` and the paged
:class:`PagedGenerativeEngine` with in-graph sampling and speculative
decoding.

Port of ``veles_tpu/serve/engine.py`` (``InferenceEngine``,
``GenerativeEngine``, ``_sample_tokens``, ``PagedGenerativeEngine``,
``bucket_for``, ``_validated_swap``), single device: no mesh, no AOT
plan, no memory plan. Where the reference compiles one executable per
shape, the port on a CUDA device captures one CUDA graph
(``veles_tpu_torch.graphs``): one per batch bucket of the forward
plane, one per decode round body (greedy, sampled, speculative) of the
generative planes, whose inputs (last tokens, lengths, the active
mask, the fault mask, block tables) are device buffers rewritten in
place between replays; prefill runs eagerly. ``compile_count`` keeps
its meaning: distinct shapes served (captured graphs on the card, the
same record on the CPU, where nothing is captured). Every tensor lives
on ``self.device``; serving runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from veles_tpu_torch.device import compute_dtype as _compute_dtype
from veles_tpu_torch.device import resolve
from veles_tpu_torch.graphs import StepGraph, use_graphs
from veles_tpu_torch.models.transformer import (compute_weights,
                                                decode_step,
                                                forward as lm_forward,
                                                init_kv_cache,
                                                init_paged_kv_cache,
                                                paged_decode_step,
                                                params_from_numpy,
                                                prefill, refresh_weights,
                                                verify_step)
from veles_tpu_torch.parallel.fused import _apply, normalize_specs
from veles_tpu_torch.serve.paging import (PagePool, PagesExhausted,
                                          kv_bytes_per_token)


def bucket_for(n: int, min_bucket: int = 1) -> int:
    """Smallest power-of-two >= n (>= min_bucket)."""
    if n < 1:
        raise ValueError("bucket_for needs n >= 1, got %d" % n)
    return max(min_bucket, 1 << (n - 1).bit_length())


def _leaves(tree, path=""):
    """(path, tensor) pairs of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], "%s/%s" % (path, key))
    elif isinstance(tree, (list, tuple)):
        for i, node in enumerate(tree):
            yield from _leaves(node, "%s/%d" % (path, i))
    else:
        yield path, tree


def _validated_swap(new: Any, current_params: Any) -> Any:
    """Validate the new tree (already on the engine's device) against
    the live one: same structure, same per-leaf shapes and dtypes — the
    hot-swap guard of every engine (a captured graph reads the live
    leaves, so the swap copies into them)."""
    old_leaves = list(_leaves(current_params))
    new_leaves = list(_leaves(new))
    if [p for p, _ in old_leaves] != [p for p, _ in new_leaves]:
        raise ValueError("swap_params: new param tree structure differs "
                         "from the engine's")
    for (path, old), (_, leaf) in zip(old_leaves, new_leaves):
        if old.shape != leaf.shape or old.dtype != leaf.dtype:
            raise ValueError(
                "swap_params: leaf %s shape/dtype mismatch (%s/%s vs "
                "%s/%s)" % (path, tuple(old.shape), old.dtype,
                            tuple(leaf.shape), leaf.dtype))
    return new


@torch.no_grad()
def _swap_lm_weights(engine, params: Any) -> None:
    """An LM engine's hot swap: validate, copy into the f32 master
    leaves, recompute the compute-dtype weights in place (a captured
    decode round reads both)."""
    new = _validated_swap(params_from_numpy(params, engine.config,
                                            engine.device), engine.params)
    with engine._lock:
        for (_, dst), (_, src) in zip(_leaves(engine.params), _leaves(new)):
            dst.copy_(src)
        refresh_weights(engine._weights, engine.params, engine.config)


def _upload(buffer: torch.Tensor, host: np.ndarray) -> None:
    """Rewrite a static device input from its host copy, in place."""
    buffer.copy_(torch.from_numpy(host))


def _place_tree(tree, device) -> Any:
    """A params tree (dicts and lists of numpy arrays or tensors) as
    f32 tensors on ``device``, copied, same structure."""
    if isinstance(tree, dict):
        return {key: _place_tree(node, device) for key, node in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place_tree(node, device) for node in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device=device, dtype=torch.float32,
                                copy=True)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


class InferenceEngine:
    """Forward + params + the bucketed shape record, one captured CUDA
    graph per batch bucket.

    ``forward_fn(params, x) -> y`` runs on ``device`` tensors and must
    be row-aligned (row i of ``y`` depends only on row i of ``x``):
    batch sizes round up to the next power of two, the input pads with
    zero rows and the output slices back, so mixed request sizes run at
    most ``log2(max_bucket)`` shapes. On a CUDA device (``cuda_graphs``
    None or True) each bucket's forward is captured once, into one
    memory pool shared by every bucket, with a static input buffer that
    :meth:`apply` rewrites in place; ``compile_count`` counts those
    graphs. ``cuda_graphs=False`` (and the CPU) runs the forward eagerly
    and records the shapes served. Use the ``from_*`` constructors
    unless you serve a custom function.
    """

    def __init__(self, forward_fn: Callable[[Any, torch.Tensor], Any],
                 params: Any, *, input_dtype=np.float32,
                 min_bucket: int = 1, name: str = "model", device=None,
                 cuda_graphs: Optional[bool] = None, mesh=None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "a sharded InferenceEngine waits for sharded serving "
                "(ROADMAP.md queue 1 item 7b)")
        self.device = resolve(device)
        self._graphs_on = use_graphs(cuda_graphs, self.device)
        self.name = name
        self.input_dtype = np.dtype(input_dtype)
        self.min_bucket = int(min_bucket)
        self._forward_fn = forward_fn
        self.params = _place_tree(params, self.device)
        #: shape -> its captured graph (None where nothing is captured)
        self._cache: Dict[Tuple[int, ...], Optional[StepGraph]] = {}
        self._pool = None
        self._swap_lock = threading.Lock()
        #: trailing params entries a body-only swap keeps (the
        #: normalizer's statistics of from_specs)
        self._swap_tail = 0

    # -- the shape record --------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Distinct bucket shapes served (captured graphs on the card;
        the reference's count of compiled executables)."""
        return len(self._cache)

    @property
    def buckets(self) -> List[int]:
        return sorted({shape[0] for shape in self._cache})

    def _graph_for(self, shape: Tuple[int, ...]) -> StepGraph:
        graph = self._cache.get(shape)
        if graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            static = torch.zeros(shape, dtype=torch.from_numpy(
                np.zeros(0, self.input_dtype)).dtype, device=self.device)
            graph = StepGraph(lambda x: self._forward_fn(self.params, x),
                              inputs=(static,), pool=self._pool)
            self._cache[shape] = graph
        return graph

    # -- serving -----------------------------------------------------------
    def apply(self, batch: np.ndarray) -> np.ndarray:
        """Forward a [N, ...] host batch; returns host rows [N, ...].
        N pads up to its bucket with zero rows; never captures more
        graphs than there are buckets."""
        batch = np.ascontiguousarray(
            np.asarray(batch, dtype=self.input_dtype))
        if batch.ndim < 2 or batch.shape[0] == 0:
            raise ValueError(
                "apply needs a non-empty [N, ...] batch, got shape %s"
                % (batch.shape,))
        n = batch.shape[0]
        bucket = bucket_for(n, self.min_bucket)
        if bucket != n:
            pad = np.zeros((bucket,) + batch.shape[1:],
                           dtype=self.input_dtype)
            pad[:n] = batch
            batch = pad
        x = torch.from_numpy(batch)
        with self._swap_lock, torch.inference_mode():
            if self._graphs_on:
                out = self._graph_for(batch.shape).replay(x)
            else:
                self._cache.setdefault(batch.shape, None)
                out = self._forward_fn(self.params, x.to(self.device))
            return out[:n].cpu().numpy()

    def warmup(self, sample_shape: Sequence[int], max_batch: int) -> int:
        """Serve every bucket up to ``max_batch`` once for one sample
        shape (captures their graphs before traffic); returns the
        number of shapes added."""
        before = self.compile_count
        b = self.min_bucket
        while True:
            self.apply(np.zeros((b,) + tuple(sample_shape),
                                dtype=self.input_dtype))
            if b >= bucket_for(max_batch, self.min_bucket):
                break
            b <<= 1
        return self.compile_count - before

    # -- hot swap ----------------------------------------------------------
    def swap_params(self, params: Any) -> None:
        """Replace the weights in place. The new tree must match the
        old one's structure, shapes and dtypes, so every captured graph
        stays valid (a refresh must not capture again). An engine with a
        normalizer's statistics as its last params entry
        (``from_specs(normalizer=)``) also takes the body's params alone
        and keeps the statistics."""
        tail = self._swap_tail
        if tail and isinstance(params, (list, tuple)) and \
                len(params) == len(self.params) - tail:
            params = list(params) + list(self.params[-tail:])
        new = _validated_swap(_place_tree(params, self.device), self.params)
        with self._swap_lock, torch.no_grad():
            for (_, dst), (_, src) in zip(_leaves(self.params),
                                          _leaves(new)):
                dst.copy_(src)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_specs(cls, specs: Sequence[Any], params: List[Dict[str, Any]],
                   *, normalizer=None, compute_dtype=None,
                   name: str = "model", **kwargs) -> "InferenceEngine":
        """Engine over a fused-classifier spec stack (the layer tuples
        ``parallel/fused.py`` trains). A leading ``("normalize",)`` spec
        (params ``{"mean", "rdisp"}``) is applied on the device.
        ``normalizer``: a loader normalizer (``apply_torch``) applied
        after the cast to the compute dtype, so clients send raw rows;
        a stateful one's statistics ride as the last params entry,
        device tensors that the captured bucket graphs read and that
        ``swap_params`` updates in place (a swap of the body's params
        alone keeps them). A softmax tail returns probabilities (the
        reference's graph parity). ``compute_dtype``: None = bfloat16
        on a CUDA device, float32 elsewhere; params and the output stay
        f32."""
        specs = normalize_specs(specs)
        pre_n = 0
        for s in specs:
            if s[0] != "normalize":
                break
            pre_n += 1
        if any(s[0] == "normalize" for s in specs[pre_n:]):
            raise ValueError(
                "('normalize',) specs must lead the stack; got %s"
                % (specs,))
        body = specs[pre_n:]
        device = resolve(kwargs.pop("device", None))
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if device.type == "cuda" \
                else torch.float32
        elif isinstance(compute_dtype, str):
            compute_dtype = _compute_dtype(compute_dtype)
        tail_act = None
        for s in body:
            if s[0] in ("fc", "conv"):
                tail_act = s[1]
        norm_arrays = normalizer.stat_arrays() or None \
            if normalizer is not None else None
        has_norm_tail = norm_arrays is not None

        def forward(all_params, x):
            x = x.to(compute_dtype)
            body_params = all_params[pre_n:-1] if has_norm_tail \
                else all_params[pre_n:]
            for p in all_params[:pre_n]:
                x = ((x - p["mean"]) * p["rdisp"]).to(compute_dtype)
            if normalizer is not None:
                x = normalizer.apply_torch(
                    x, all_params[-1] if has_norm_tail else None)
            h = _apply(body, False, body_params, x, 0, compute_dtype)
            if tail_act == "softmax":
                h = torch.softmax(h.float(), dim=-1)
            return h

        if has_norm_tail:
            params = list(params) + [norm_arrays]
        engine = cls(forward, params, name=name, device=device, **kwargs)
        if has_norm_tail:
            engine._swap_tail = 1
        return engine

    @classmethod
    def from_transformer(cls, config, params, **kwargs) -> \
            "InferenceEngine":
        """Engine over a TransformerConfig LM: int32 token rows [N, T]
        in, f32 logits [N, T, V] out. Pass a trained
        ``TransformerTrainer.params`` (or ``init_params`` output)."""
        device = resolve(kwargs.pop("device", None))

        def fwd(p, tokens):
            return lm_forward(p, tokens.long(), config)[0]

        kwargs.setdefault("input_dtype", np.int32)
        kwargs.setdefault("name", "transformer_lm")
        return cls(fwd, params_from_numpy(params, config, device),
                   device=device, **kwargs)

    @classmethod
    def from_forwards(cls, forwards: Sequence[Any],
                      **kwargs) -> "InferenceEngine":
        """Engine over a stack of trained forward units
        (``fuse_forwards``: their specs and params)."""
        from veles_tpu_torch.parallel.fused import fuse_forwards
        specs, params = fuse_forwards(forwards)
        return cls.from_specs(specs, params, **kwargs)

    @classmethod
    def from_workflow(cls, workflow, **kwargs) -> "InferenceEngine":
        """Engine over a StandardWorkflow-shaped graph: its forward
        stack and its loader's input normalizer."""
        kwargs.setdefault("normalizer",
                          getattr(workflow.loader, "normalizer", None))
        kwargs.setdefault("name", type(workflow).__name__)
        return cls.from_forwards(workflow.forwards, **kwargs)

    @classmethod
    def from_snapshot(cls, path: str, **kwargs) -> "InferenceEngine":
        """Engine from a Snapshotter snapshot (a file, a manifest or
        directory of a sharded one, or a ``db://`` URI): restore the
        workflow on the host, then take its forward stack."""
        from veles_tpu_torch.snapshotter import Snapshotter
        return cls.from_workflow(Snapshotter.load(path), **kwargs)

    @classmethod
    def from_package(cls, path: str, **kwargs) -> "InferenceEngine":
        raise NotImplementedError(
            "package archives wait for the port's package export and "
            "AOT artifacts (ROADMAP.md queue 1 item 10)")


class GenerativeEngine:
    """KV-cache autoregressive decode plane over a transformer LM.

    A prompt is prefilled ONCE into a slot of a device-resident KV
    slab; every later token costs one single-query flash-decode step
    over the cache instead of a full re-prefill.

    Shape policy (the bucketed-slab discipline of the reference):

    - the slab has a fixed shape ``[L, max_slots, cap, H, Dh]`` (``cap``
      = power-of-two round-up of ``max_len``) and every decode step
      runs all slots (inactive slots are masked, not reshaped);
    - prompt batches round up to power-of-two (batch, length) buckets,
      so mixed prompts run at most ``log2(slots) * log2(seq)`` shapes.

    Slots are allocated at admission (:meth:`admit`) and freed at
    retirement (:meth:`release`); the continuous
    :class:`~veles_tpu_torch.serve.batcher.TokenBatcher` drives both at
    token boundaries. Greedy (argmax) sampling happens on the device,
    so each step ships one int32 per slot (plus the per-slot finite
    flag) back to the host, not a ``[slots, vocab]`` logits buffer.

    ``cuda_graphs`` (None = on a CUDA device): the decode step is one
    captured CUDA graph, captured by :meth:`warm` or at the first
    :meth:`decode`, replayed by every later one; admit, release, a
    fault mask and :meth:`swap_params` rewrite its inputs in place and
    never capture again. ``False`` runs the same step eagerly.
    """

    def __init__(self, config, params, *, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 min_prefill_bucket: int = 8,
                 name: str = "generative_lm",
                 device=None, cuda_graphs: Optional[bool] = None) -> None:
        self.device = resolve(device)
        self._graphs_on = use_graphs(cuda_graphs, self.device)
        self.config = config
        self.name = name
        self.max_len = int(min(max_len or config.seq_len,
                               config.seq_len))
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.slots = int(max_slots)
        self.cache_capacity = bucket_for(self.max_len)
        self.min_prefill_bucket = int(min_prefill_bucket)
        self.params = params_from_numpy(params, config, self.device)
        self._weights = compute_weights(self.params, config)
        self._cache = init_kv_cache(config, self.slots,
                                    self.cache_capacity,
                                    device=self.device)
        # the decode step's static inputs: written in place, never
        # rebound (a captured step reads them at fixed addresses)
        self._lengths = torch.zeros(self.slots, dtype=torch.int32,
                                    device=self.device)
        self._last_tokens = torch.zeros(self.slots, dtype=torch.int32,
                                        device=self.device)
        self._active_dev = torch.zeros(self.slots, dtype=torch.bool,
                                       device=self.device)
        self._inject_dev = torch.zeros(self.slots, dtype=torch.bool,
                                       device=self.device)
        self._active = np.zeros(self.slots, bool)
        self._active_stale = False
        self._inject = np.zeros(self.slots, bool)
        #: host mirror of the device lengths, for /metrics (a read of
        #: the device copy from another thread would sync, and break a
        #: capture under way)
        self._host_len = np.zeros(self.slots, np.int64)
        self._graph: Optional[StepGraph] = None
        #: serializes the device work of the dispatch thread (prefill,
        #: decode, capture) with a hot swap from another thread
        self._lock = threading.Lock()
        self._free = list(range(self.slots))
        self._prefill_seen: Set[Tuple[int, int]] = set()
        self._decode_ran = False
        self._decode_steps = 0
        #: per-slot finite-logits sentinel from the LAST decode step
        #: (host bool [slots]; True = healthy). All-True until the
        #: first decode.
        self.last_finite = np.ones(self.slots, bool)
        #: test hook (serve-side fault injection): called with the
        #: decode-step index, returns an iterable of slot ids whose
        #: logits get NaN'd on the device this step — exercises the
        #: real sentinel path.
        self.decode_fault_hook: Optional[Callable[[int], Any]] = None

    # -- device bodies -----------------------------------------------------
    def _decode_fn(self) -> torch.Tensor:
        """The decode step, the captured body: reads only the static
        inputs, returns ``[2, slots]`` int32 (tokens, finite flags)."""
        active = self._active_dev
        logits, _, lengths = decode_step(
            self._weights, self._last_tokens, self._cache, self._lengths,
            self.config, active=active)
        # all-False outside fault injection: bitwise the identity
        logits = logits.masked_fill(self._inject_dev[:, None],
                                    float("nan"))
        # the sentinel: one flag per slot back to the host; a
        # non-finite slot keeps its previous last token so the slab
        # state stays well defined until the batcher retires it
        finite = torch.isfinite(logits).all(dim=-1)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self._last_tokens.copy_(torch.where(active & finite, nxt,
                                            self._last_tokens))
        self._lengths.copy_(lengths)
        return torch.stack([nxt, finite.to(torch.int32)])

    def _prefill_fn(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    slots: Sequence[int]) -> torch.Tensor:
        logits, prompt = prefill(self._weights, tokens, lengths,
                                 self.config)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        # scatter the real rows into their slots (padding rows of the
        # batch bucket are dropped, as the reference's out-of-range
        # slot ids are) and zero each slot's tail, so a reallocated
        # slot never inherits a predecessor's K/V; in place, where the
        # reference updates a donated slab
        n, tb = len(slots), tokens.shape[1]
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for key in ("k", "v"):
            self._cache[key][:, idx, :tb] = prompt[key][:, :n].to(
                self._cache[key].dtype)
            self._cache[key][:, idx, tb:] = 0
        self._lengths[idx] = lengths[:n].to(torch.int32)
        self._last_tokens[idx] = nxt[:n]
        return nxt[:n]

    # -- the shape record --------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Distinct shapes served: one per (batch, length) prefill
        bucket pair + at most ONE decode step (the captured graph on
        the card; the reference's count of compiled executables)."""
        return len(self._prefill_seen) + int(self._decode_ran)

    @property
    def prefill_buckets(self) -> List[Tuple[int, int]]:
        return sorted(self._prefill_seen)

    # -- slots -------------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return int(self._active.sum())

    def release(self, slot: int) -> None:
        """Retire a sequence: its slot is immediately reusable (the
        next prefill overwrites the whole slot row)."""
        if not self._active[slot]:
            raise ValueError("slot %d is not active" % slot)
        self._active[slot] = False
        self._active_stale = True
        self._free.append(slot)

    # -- serving -----------------------------------------------------------
    def admit(self, prompts: Sequence[np.ndarray]
              ) -> Tuple[List[int], np.ndarray]:
        """Prefill ``prompts`` (list of 1-D int token arrays) into
        freshly allocated slots as ONE bucketed batch. Returns
        ``(slot_ids, first_tokens)`` — the greedy next token per prompt
        is already computed (generation starts at token 1). Raises
        ``ValueError`` when prompts outnumber free slots or a prompt is
        empty/too long."""
        n = len(prompts)
        if n == 0:
            raise ValueError("admit needs at least one prompt")
        if n > self.free_slots:
            raise ValueError("admit: %d prompts > %d free slots"
                             % (n, self.free_slots))
        rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        lens = [len(r) for r in rows]
        if min(lens) < 1:
            raise ValueError("admit: empty prompt")
        if max(lens) > self.max_len:
            raise ValueError("admit: prompt length %d > max_len %d"
                             % (max(lens), self.max_len))
        bb = bucket_for(n)
        # length bucket clamped to BOTH the position table and the slab
        tb = min(bucket_for(max(lens), self.min_prefill_bucket),
                 self.config.seq_len, self.cache_capacity)
        tokens = np.zeros((bb, tb), np.int32)
        lengths = np.zeros((bb,), np.int32)
        taken = [self._free.pop() for _ in range(n)]
        try:
            for i, row in enumerate(rows):
                tokens[i, :lens[i]] = row
                lengths[i] = lens[i]
            with self._lock, torch.inference_mode():
                nxt = self._prefill_fn(
                    torch.from_numpy(tokens).to(self.device).long(),
                    torch.from_numpy(lengths).to(self.device), taken)
                first = nxt.cpu().numpy()
        except BaseException:
            self._free.extend(taken)  # a failed prefill must not leak
            raise
        self._prefill_seen.add((bb, tb))
        for i, slot in enumerate(taken):
            self._active[slot] = True
            self._host_len[slot] = lens[i]
        self._active_stale = True
        return taken, first

    def decode(self) -> np.ndarray:
        """One decode step for the WHOLE slab (every active sequence
        advances one token; inactive slots are masked). Returns the
        greedy next token per slot ``[slots] int32`` — index it with
        the slot ids :meth:`admit` returned. After each step,
        :attr:`last_finite` says per slot whether its logits were
        finite — the caller retires non-finite slots."""
        inject = _fault_mask(self.decode_fault_hook, self._decode_steps,
                             self.slots)
        self._decode_steps += 1
        with self._lock, torch.inference_mode():
            if self._active_stale:
                _upload(self._active_dev, self._active)
                self._active_stale = False
            if not np.array_equal(inject, self._inject):
                _upload(self._inject_dev, inject)
                self._inject = inject
            if not self._graphs_on:
                out = self._decode_fn()
            else:
                if self._graph is None:
                    # the warm-up calls write K/V only at each slot's
                    # length, which every read masks and the captured
                    # step rewrites; the lengths and tokens come back
                    self._graph = StepGraph(
                        self._decode_fn,
                        keep=(self._lengths, self._last_tokens))
                out = self._graph.replay()
            # one transfer: tokens and flags as int32 [2, slots]
            host = out.cpu().numpy()
        self._decode_ran = True
        live = np.flatnonzero(self._active)
        self._host_len[live] = np.minimum(self._host_len[live] + 1,
                                          self.cache_capacity)
        self.last_finite = host[1].astype(bool)
        return host[0]

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int, eos: Optional[int] = None
                 ) -> List[np.ndarray]:
        """Batch-greedy generation (tests and the smoke run drive this;
        production traffic goes through the TokenBatcher). Returns the
        generated tokens per prompt (EOS included when hit)."""
        slots, first = self.admit(prompts)
        done = [False] * len(prompts)
        out: List[List[int]] = [[] for _ in prompts]
        for i, tok in enumerate(first):
            out[i].append(int(tok))
            if (eos is not None and int(tok) == eos) or \
                    max_new_tokens <= 1:
                done[i] = True
                self.release(slots[i])
        while not all(done):
            nxt = self.decode()
            for i, slot in enumerate(slots):
                if done[i]:
                    continue
                tok = int(nxt[slot])
                out[i].append(tok)
                if (eos is not None and tok == eos) or \
                        len(out[i]) >= max_new_tokens:
                    done[i] = True
                    self.release(slot)
        return [np.asarray(o, np.int32) for o in out]

    def warm(self) -> int:
        """Run the full shape ladder before traffic: one prefill per
        (batch-bucket, length-bucket) pair plus one decode step, through
        the real admit/release path (builds the kernels, fills
        PyTorch's allocator cache and, on a CUDA device, captures the
        decode step). Returns the shapes added."""
        before = self.compile_count
        cap = min(self.cache_capacity, self.config.seq_len,
                  self.max_len)
        lens = []
        ln = min(self.min_prefill_bucket, self.max_len)
        while ln < cap:
            lens.append(ln)
            ln <<= 1
        lens.append(cap)
        counts = []
        bb = 1
        while bb < self.slots:
            counts.append(bb)
            bb <<= 1
        counts.append(self.slots)
        for n in counts:
            for ln in lens:
                slots, _ = self.admit([np.ones(ln, np.int32)] * n)
                for slot in slots:
                    self.release(slot)
        self.decode()
        return self.compile_count - before

    # -- observability -----------------------------------------------------
    def decode_stats(self) -> Dict[str, Any]:
        """Decode-plane gauges for /metrics (host-side snapshot: it
        touches no device tensor)."""
        active = self._active
        return {
            "active_sequences": int(active.sum()),
            "slots": self.slots,
            "slot_occupancy": float(active.sum()) / self.slots,
            "cache_capacity": self.cache_capacity,
            "cache_tokens": int(self._host_len[active].sum()) if
            active.any() else 0,
            "compile_count": self.compile_count,
            "prefill_buckets": ["%dx%d" % b for b in
                                self.prefill_buckets],
            "device": str(self.device),
        }

    # -- hot swap ----------------------------------------------------------
    def swap_params(self, params: Any) -> None:
        """Replace the weights (same tree structure, shapes and dtypes),
        in place. Sequences mid-decode continue with the new weights
        from their next step."""
        _swap_lm_weights(self, params)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_trainer(cls, trainer, **kwargs) -> "GenerativeEngine":
        """Engine over anything with ``.config`` / ``.params``."""
        kwargs.setdefault("name", "generative_lm")
        return cls(trainer.config, trainer.params, **kwargs)


def _fault_mask(hook, step: int, slots: int) -> np.ndarray:
    """The slots whose logits a test's fault hook NaNs this step, as a
    host bool mask (all False without a hook)."""
    mask = np.zeros(slots, bool)
    if hook is not None:
        for slot in hook(step) or ():
            mask[int(slot)] = True
    return mask


# ---------------------------------------------------------------------------
# sampling: temperature, top-k, top-p over a counter-based random stream
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
#: threefry-2x32's rotation constants (Salmon et al., SC 2011; the
#: generator JAX keys its PRNG with)
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, c0, c1):
    """threefry-2x32, 20 rounds: key ``(k0, k1)``, counter ``(c0,
    c1)``, each a broadcastable int64 tensor holding 32-bit values;
    returns the two 32-bit output words as int64 tensors. Built from
    64-bit adds, shifts and xors masked to 32 bits, so the CPU and the
    card compute the same bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _gumbel(seed, counter, n: int) -> torch.Tensor:
    """``[N, n]`` float64 Gumbel noise, a pure function of (seed,
    counter, column): threefry keyed by the row's ``(seed, counter)``
    at counter block ``(column, 0)``, the top 24 bits of the first
    word as a uniform in (0, 1), then ``-log(-log(u))``. No generator
    state: a row's noise does not depend on its slot, its neighbours
    or the device."""
    dev = seed.device
    col = torch.arange(n, dtype=torch.int64, device=dev)[None]
    bits, _ = _threefry2x32(seed.long()[:, None] & _M32,
                            counter.long()[:, None] & _M32, col,
                            torch.zeros_like(col))
    u = ((bits >> 8).double() + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def _sample_tokens(logits, temp, top_k, top_p, seed, counter):
    """Token sampling: temperature + top-k + top-p over ``[N, V]`` f32
    logits, op for op the reference's ``_sample_tokens``, drawing with
    Gumbel-max from :func:`_gumbel` where the reference draws
    ``categorical`` from ``fold_in(PRNGKey(seed), counter)``: the draw
    depends only on the ticket's seed and its token index, never on
    slot placement or batch composition. ``temp <= 0`` rows take the
    argmax (the greedy plane's token, no noise drawn); ``top_k <= 0``
    disables the k filter; ``top_p`` in (0, 1] keeps the smallest
    nucleus of cumulative probability ``>= top_p`` (the argmax always
    survives, so no filter empties a row). The filter math runs in f32
    like the reference's; the noise and the final argmax in f64."""
    n, v = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    safe_temp = torch.where(temp > 0, temp, torch.ones_like(temp)).float()
    scaled = logits.float() / safe_temp[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.clamp(torch.where(top_k > 0, top_k,
                                    torch.full_like(top_k, v)), 1, v)
    kth = desc.gather(-1, (k_eff - 1)[:, None].long())           # [N,1]
    probs = torch.softmax(desc, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    in_nucleus = (csum - probs) < top_p.float()[:, None]  # exclusive prefix
    p_thresh = torch.where(in_nucleus, desc, torch.full_like(
        desc, torch.inf)).amin(dim=-1, keepdim=True)
    keep = (scaled >= kth) & (scaled >= p_thresh)
    keep = keep | (scaled >= desc[:, :1])                 # argmax survives
    masked = torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))
    sampled = torch.argmax(masked.double() + _gumbel(seed, counter, v),
                           dim=-1).to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


class PagedGenerativeEngine:
    """Paged KV decode plane: the :class:`GenerativeEngine` contract
    over a shared PAGE POOL instead of a per-slot slab.

    K/V lives in ``serve/paging.py`` pages (``[L, n_pages + 1,
    page_size, H, Dh]``, the last one the trash page of
    :func:`~veles_tpu_torch.models.transformer.init_paged_kv_cache`);
    each slot owns an ordered block table of page ids, admission takes
    pages for the tokens a prompt ACTUALLY has (sharing common prompt
    heads by refcount), and decode takes one page every ``page_size``
    tokens. ``max_slots`` therefore oversubscribes device memory: the
    pool can be sized well under ``slots x max_len``, with
    :class:`~veles_tpu_torch.serve.paging.PagesExhausted` backpressure
    (preempt and requeue at a token boundary) when the bet loses.

    Shape record (the reference's compile census): one prefill per
    (batch, length) bucket pair, ONE decode step (or, speculating, ONE
    draft propose + ONE target verify), ONE copy-on-write page copy.
    The block tables are data, so page assignment never adds a shape.

    Two decode capabilities the slab plane lacks ride the same step:

    - sampling (:func:`_sample_tokens`): per-slot temperature, top-k
      and top-p with counter-based random streams carried in the
      per-slot state, deterministic per ticket seed and independent of
      slot placement and join order;
    - SPECULATIVE DECODING: a small draft LM (``draft_params`` /
      ``draft_config``, same vocab) proposes ``draft_tokens`` greedy
      continuations per slot through its slab ``decode_step`` (K4 on
      the card); the target verifies the whole chunk in ONE batched
      step over the same pages and commits the matched run plus one
      correction token (Leviathan et al., ICML 2023: greedy
      acceptance). Rejected K/V is masked by length and overwritten in
      place: no rollback.

    ``cuda_graphs`` (None = on a CUDA device): a decode round is one
    captured CUDA graph, one per round body the host picks (greedy,
    sampled; with a draft, propose + verify in one graph), each
    captured at its first round and replayed after. The active mask,
    the fault mask and the block tables are device buffers rewritten in
    place; page admission, preemption and the COW copies run on the
    host and the device before the replay and never capture again.
    ``False`` runs the same rounds eagerly.
    """

    def __init__(self, config, params, *, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 page_size: int = 16,
                 n_pages: Optional[int] = None,
                 hbm_bytes: Optional[int] = None,
                 min_prefill_bucket: int = 8,
                 draft_params: Any = None,
                 draft_config: Any = None,
                 draft_tokens: int = 4,
                 name: str = "paged_lm",
                 device=None, cuda_graphs: Optional[bool] = None) -> None:
        self.device = resolve(device)
        self._graphs_on = use_graphs(cuda_graphs, self.device)
        self.config = config
        self.name = name
        self.input_dtype = np.dtype(np.int32)
        self.max_len = int(min(max_len or config.seq_len,
                               config.seq_len))
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.slots = int(max_slots)
        self.cache_capacity = bucket_for(self.max_len)
        self.page_size = int(page_size)
        if self.page_size > self.cache_capacity:
            raise ValueError(
                "page_size %d > cache capacity %d (pow2 of max_len); "
                "use a smaller page" % (self.page_size,
                                        self.cache_capacity))
        self.n_blocks = self.cache_capacity // self.page_size
        dtype = config.compute_dtype()
        token_bytes = kv_bytes_per_token(
            config.layers, config.heads, config.head_dim,
            torch.empty((), dtype=dtype).element_size())
        if n_pages is not None:
            pool_pages = int(n_pages)
        elif hbm_bytes is not None:
            pool_pages = int(hbm_bytes) // (self.page_size * token_bytes)
        else:
            # un-oversubscribed default: worst case, every slot full
            pool_pages = self.slots * self.n_blocks
        if pool_pages < self.n_blocks:
            raise ValueError(
                "pool of %d pages cannot hold ONE max-length sequence "
                "(%d blocks of %d tokens)" % (pool_pages, self.n_blocks,
                                              self.page_size))
        self.pool = PagePool(pool_pages, self.page_size)
        self.min_prefill_bucket = int(min_prefill_bucket)
        self.params = params_from_numpy(params, config, self.device)
        self._weights = compute_weights(self.params, config)
        self._cache = init_paged_kv_cache(config, self.pool.n_pages,
                                          self.page_size,
                                          device=self.device)
        # speculative plane (optional)
        self.draft_config = draft_config
        self.draft_tokens = int(draft_tokens)
        self.has_draft = draft_params is not None
        self.draft_params: Dict[str, Any] = {}
        self._draft_weights: Dict[str, Any] = {}
        self._draft_cache: Dict[str, torch.Tensor] = {}
        if self.has_draft:
            if draft_config is None:
                raise ValueError("draft_params needs draft_config")
            if draft_config.vocab != config.vocab:
                raise ValueError(
                    "draft vocab %d != target vocab %d"
                    % (draft_config.vocab, config.vocab))
            if draft_config.seq_len < self.max_len:
                raise ValueError(
                    "draft seq_len %d < max_len %d (the draft must "
                    "reach every position the target serves)"
                    % (draft_config.seq_len, self.max_len))
            if self.draft_tokens < 1:
                raise ValueError("draft_tokens must be >= 1")
            self.draft_params = params_from_numpy(draft_params,
                                                  draft_config,
                                                  self.device)
            self._draft_weights = compute_weights(self.draft_params,
                                                  draft_config)
            # the draft keeps a plain slab: it is small by construction,
            # so paging it would spend bookkeeping to save little
            self._draft_cache = init_kv_cache(draft_config, self.slots,
                                              self.cache_capacity,
                                              device=self.device)
        self.supports_sampling = True
        # per-slot decode state on the device, written at prefill and
        # advanced IN PLACE by every decode round
        zeros = dict(dtype=torch.int32, device=self.device)
        self._state = {
            "lengths": torch.zeros(self.slots, **zeros),
            "tokens": torch.zeros(self.slots, **zeros),
            "counters": torch.zeros(self.slots, dtype=torch.int64,
                                    device=self.device),
            "temp": torch.zeros(self.slots, dtype=torch.float32,
                                device=self.device),
            "top_k": torch.zeros(self.slots, **zeros),
            "top_p": torch.ones(self.slots, dtype=torch.float32,
                                device=self.device),
            # uint32 seeds, carried in int64 and masked to 32 bits
            "seed": torch.zeros(self.slots, dtype=torch.int64,
                                device=self.device),
            "draft": torch.zeros(self.slots, dtype=torch.bool,
                                 device=self.device),
        }
        # host bookkeeping (owned by the dispatch thread)
        self._active = np.zeros(self.slots, bool)
        self._free = list(range(self.slots))
        self._tables = np.full((self.slots, self.n_blocks),
                               self.pool.n_pages, np.int32)
        # the round's static inputs beside ``_state``: device copies of
        # ``_active`` / ``_tables`` and the fault mask, rewritten in
        # place when the host copy changed (never rebound: a captured
        # round reads them at fixed addresses)
        self._active_dev = torch.zeros(self.slots, dtype=torch.bool,
                                       device=self.device)
        self._tables_dev = torch.from_numpy(self._tables).to(self.device)
        self._inject_dev = torch.zeros(self.slots, dtype=torch.bool,
                                       device=self.device)
        self._active_stale = False
        self._tables_stale = False
        self._inject = np.zeros(self.slots, bool)
        #: captured rounds by body, ``sampling`` -> graph, sharing a pool
        self._graphs: Dict[bool, StepGraph] = {}
        self._pool = None
        #: serializes the dispatch thread's device work with a hot swap
        self._lock = threading.Lock()
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.slots)]
        self._host_len = np.zeros(self.slots, np.int64)
        self._admit_stamp = np.zeros(self.slots, np.int64)
        self._admit_seq = 0
        self._temp_np = np.zeros(self.slots, np.float32)
        self._draft_np = np.zeros(self.slots, bool)
        self._auto_seed = 0
        self._prepared = False
        # the shape record
        self._prefill_seen: Set[Tuple[int, int]] = set()
        self._decode_ran = False
        self._verify_ran = False
        self._propose_ran = False
        self._copy_ran = False
        self._decode_steps = 0
        self.last_finite = np.ones(self.slots, bool)
        self.decode_fault_hook: Optional[Callable[[int], Any]] = None
        # speculative and preemption accounting (host counters)
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.preempted_total = 0

    # -- device bodies -----------------------------------------------------
    def _next_tokens(self, logits, opts, sampling: bool) -> torch.Tensor:
        """The next token per row: :func:`_sample_tokens` when any row
        of the batch samples (``sampling``, known on the host), else
        the argmax, which is what every row's ``temp <= 0`` branch
        takes anyway."""
        if sampling:
            return _sample_tokens(logits, opts["temp"], opts["top_k"],
                                  opts["top_p"], opts["seed"],
                                  opts["counters"])
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _prefill_fn(self, tokens, lengths, slots: Sequence[int],
                    write_tables, req, sampling: bool) -> torch.Tensor:
        """One bucketed call: target prefill, page scatter, slot state
        scatter (and the draft's slab prefill when speculating). The
        first token is drawn here at the ticket's counter (it resumes
        across preemption). ``write_tables`` carries the ``n_pages``
        sentinel for SHARED pages (never overwrite a donor) and pad
        tiles: their writes land on the trash page."""
        logits, prompt = prefill(self._weights, tokens, lengths,
                                 self.config)
        nxt = self._next_tokens(logits, req, sampling)
        bb, tb = tokens.shape
        ps = self.page_size
        n_tiles = -(-tb // ps)
        layers, heads, hd = (self.config.layers, self.config.heads,
                             self.config.head_dim)
        for key in ("k", "v"):
            tiles = torch.nn.functional.pad(
                prompt[key], (0, 0, 0, 0, 0, n_tiles * ps - tb)).reshape(
                    layers, bb, n_tiles, ps, heads, hd)
            self._cache[key][:, write_tables] = tiles.to(
                self._cache[key].dtype)
        n = len(slots)
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        state = self._state
        state["lengths"][idx] = lengths[:n].to(torch.int32)
        state["tokens"][idx] = nxt[:n]
        state["counters"][idx] = req["counters"][:n] + 1
        for key in ("temp", "top_k", "top_p", "seed", "draft"):
            state[key][idx] = req[key][:n]
        if self.has_draft:
            # the draft ingests EVERY admitted prompt (speculating or
            # not), and its slot's tail is zeroed like the slab's
            _, dprompt = prefill(self._draft_weights, tokens, lengths,
                                 self.draft_config)
            for key in ("k", "v"):
                self._draft_cache[key][:, idx, :tb] = dprompt[key][:, :n].to(
                    self._draft_cache[key].dtype)
                self._draft_cache[key][:, idx, tb:] = 0
        return nxt[:n]

    def _decode_fn(self, tables, active, inject, sampling: bool):
        """The ONE paged decode step: write K/V through the block
        table, attend through it (K5 on the card), draw, advance the
        per-slot state in place."""
        state = self._state
        logits, self._cache, new_len = paged_decode_step(
            self._weights, state["tokens"], self._cache, state["lengths"],
            tables, self.config, active=active)
        logits = logits.masked_fill(inject[:, None], float("nan"))
        finite = torch.isfinite(logits).all(dim=-1)
        nxt = self._next_tokens(logits, state, sampling)
        ok = active & finite
        state["lengths"].copy_(new_len)
        state["tokens"].copy_(torch.where(ok, nxt, state["tokens"]))
        state["counters"].add_(ok.to(torch.int64))
        return nxt, finite

    def _propose_fn(self, active) -> torch.Tensor:
        """Draft proposal: K greedy slab decode steps, then one more
        that only writes the K-th proposal's K/V. With it the draft's
        valid prefix equals the target length at every round start
        (accepted tokens are exactly the proposals it ingested), so the
        TARGET lengths drive it. The reference runs K steps only: after
        a round that accepts all K proposals its draft attends one
        position it never wrote, and acceptance drops below what the
        draft can give (ROADMAP.md, queue 3)."""
        state = self._state
        lengths, tok = state["lengths"], state["tokens"]
        props = []
        for _ in range(self.draft_tokens + 1):
            logits, self._draft_cache, lengths = decode_step(
                self._draft_weights, tok, self._draft_cache, lengths,
                self.draft_config, active=active)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            tok = torch.where(active, nxt, tok)
            props.append(nxt)
        return torch.stack(props[:-1], dim=1)            # [slots, K]

    def _verify_fn(self, tables, proposals, active, inject,
                   sampling: bool):
        """Target verification: ONE batched step over the chunk
        ``[last_token, p_1..p_K]``. Greedy acceptance: the accepted run
        is the longest prefix where the proposal equals the target's
        argmax, plus one correction token; sampled (``temp > 0``) or
        draft-less slots get exactly the plain decode semantics (count
        1, position 0 drawn at the slot's counter)."""
        state = self._state
        k = self.draft_tokens
        chunk = torch.cat([state["tokens"][:, None], proposals], dim=1)
        logits, self._cache = verify_step(
            self._weights, chunk, self._cache, state["lengths"], tables,
            self.config, active=active)
        logits = logits.masked_fill(inject[:, None, None], float("nan"))
        finite = torch.isfinite(logits).all(dim=-1).all(dim=-1)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        match = (proposals == greedy[:, :k]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        spec_row = state["draft"] & (state["temp"] <= 0.0) & active
        n_acc = torch.where(spec_row, n_acc, torch.zeros_like(n_acc))
        # accepted proposals ARE the greedy tokens; a sampled slot
        # re-draws position 0 at its counter (the plain step's draw)
        emitted = greedy.clone()
        emitted[:, 0] = self._next_tokens(logits[:, 0], state, sampling)
        ok = active & finite
        counts = torch.where(ok, n_acc + 1, active.to(torch.int32))
        cap = self.n_blocks * self.page_size
        last = emitted.gather(1, torch.clamp(counts - 1, 0, k)[:, None]
                              .long())[:, 0]
        state["lengths"].copy_(torch.clamp(state["lengths"] + counts,
                                           max=cap))
        state["tokens"].copy_(torch.where(ok, last, state["tokens"]))
        state["counters"].add_(torch.where(ok, counts,
                                           torch.zeros_like(counts)))
        return emitted, counts, finite, n_acc

    def _round_fn(self, sampling: bool) -> torch.Tensor:
        """One decode round over the static inputs, the captured body:
        the speculative propose + verify with a draft, else the decode
        step. Returns one int32 block for the host: ``[slots, K + 4]``
        (emitted, counts, finite, accepted) speculating, else ``[2,
        slots]`` (tokens, finite)."""
        active, tables = self._active_dev, self._tables_dev
        if self.has_draft:
            proposals = self._propose_fn(active)
            emitted, counts, finite, n_acc = self._verify_fn(
                tables, proposals, active, self._inject_dev, sampling)
            return torch.cat([emitted, counts[:, None],
                              finite.to(torch.int32)[:, None],
                              n_acc[:, None]], dim=1)
        nxt, finite = self._decode_fn(tables, active, self._inject_dev,
                                      sampling)
        return torch.stack([nxt, finite.to(torch.int32)])

    def _copy_pages(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Copy-on-write page copies for every layer's K and V in one
        indexed copy (the rows a COW re-pointed; none is a no-op)."""
        if len(dst):
            s = torch.as_tensor(src, dtype=torch.long, device=self.device)
            d = torch.as_tensor(dst, dtype=torch.long, device=self.device)
            for key in ("k", "v"):
                self._cache[key][:, d] = self._cache[key][:, s]
        self._copy_ran = True

    # -- the shape record --------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Distinct shapes served: one per (batch, length) prefill
        bucket pair + ONE decode (or propose + verify) + ONE COW page
        copy (the reference's count of compiled executables)."""
        return (len(self._prefill_seen) + int(self._decode_ran) +
                int(self._verify_ran) + int(self._propose_ran) +
                int(self._copy_ran))

    @property
    def prefill_buckets(self) -> List[Tuple[int, int]]:
        return sorted(self._prefill_seen)

    # -- slots -------------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return int(self._active.sum())

    def release(self, slot: int) -> None:
        """Retire a sequence: decref its pages (shared pages survive in
        their donors; private ones return to the pool) and free the
        slot."""
        if not self._active[slot]:
            raise ValueError("slot %d is not active" % slot)
        self.pool.release(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._tables[slot, :] = self.pool.n_pages
        self._host_len[slot] = 0
        self._active[slot] = False
        self._active_stale = True
        self._tables_stale = True
        self._free.append(slot)

    # -- admission ---------------------------------------------------------
    def admit_capacity(self, prompt_lens: Sequence[int]) -> int:
        """How many of these prompts (in order) the pool can admit
        RIGHT NOW, ignoring sharing (a conservative floor). The batcher
        trims its admission batch to this, so :meth:`admit` never fails
        mid-quantum."""
        free = self.pool.free_pages
        n = 0
        for ln in prompt_lens:
            need = self.pool.pages_for(int(ln))
            if need > free:
                break
            free -= need
            n += 1
        return n

    def admit(self, prompts: Sequence[np.ndarray],
              sampling: Optional[Sequence[Optional[Dict[str, Any]]]]
              = None) -> Tuple[List[int], np.ndarray]:
        """Admit ``prompts`` into fresh slots as ONE bucketed call: page
        admission (prefix sharing + refcounts) on the host, then
        prefill + page scatter + state scatter on the device.
        ``sampling[i]`` optionally carries ``temperature`` / ``top_k``
        / ``top_p`` / ``seed`` / ``counter`` / ``draft`` for prompt i
        (defaults: greedy, counter 0, no draft). Raises ``ValueError``
        on slot/length violations and :class:`PagesExhausted` (nothing
        leaked) when the pool cannot cover the prompts."""
        n = len(prompts)
        if n == 0:
            raise ValueError("admit needs at least one prompt")
        if n > self.free_slots:
            raise ValueError("admit: %d prompts > %d free slots"
                             % (n, self.free_slots))
        rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        lens = [len(r) for r in rows]
        if min(lens) < 1:
            raise ValueError("admit: empty prompt")
        if max(lens) > self.max_len:
            raise ValueError("admit: prompt length %d > max_len %d"
                             % (max(lens), self.max_len))
        sampling = list(sampling) if sampling is not None \
            else [None] * n
        if len(sampling) != n:
            raise ValueError("admit: %d sampling entries for %d "
                             "prompts" % (len(sampling), n))
        # page admission first (atomic: any failure rolls everything
        # back before the raise; slots and pool untouched)
        page_lists: List[List[Tuple[int, bool]]] = []
        try:
            for row in rows:
                page_lists.append(self.pool.admit_prompt(row.tolist()))
        except BaseException:
            for taken_pages in page_lists:
                self.pool.release([p for p, _ in taken_pages])
            raise
        bb = bucket_for(n)
        tb = min(bucket_for(max(lens), self.min_prefill_bucket),
                 self.config.seq_len, self.cache_capacity)
        n_tiles = -(-tb // self.page_size)
        tokens = np.zeros((bb, tb), np.int32)
        lengths = np.zeros((bb,), np.int32)
        write_tables = np.full((bb, n_tiles), self.pool.n_pages, np.int64)
        req = {"temp": np.zeros(bb, np.float32),
               "top_k": np.zeros(bb, np.int32),
               "top_p": np.ones(bb, np.float32),
               "seed": np.zeros(bb, np.int64),
               "counters": np.zeros(bb, np.int64),
               "draft": np.zeros(bb, bool)}
        taken = [self._free.pop() for _ in range(n)]
        try:
            for i, row in enumerate(rows):
                tokens[i, :lens[i]] = row
                lengths[i] = lens[i]
                for j, (pid, shared) in enumerate(page_lists[i]):
                    if not shared:
                        write_tables[i, j] = pid
                opts = sampling[i] or {}
                req["temp"][i] = float(opts.get("temperature", 0.0))
                req["top_k"][i] = int(opts.get("top_k", 0))
                req["top_p"][i] = float(opts.get("top_p", 1.0))
                seed = opts.get("seed")
                if seed is None:
                    seed = self._auto_seed
                    self._auto_seed += 1
                req["seed"][i] = int(seed) & 0xFFFFFFFF
                req["counters"][i] = int(opts.get("counter", 0))
                req["draft"][i] = bool(opts.get("draft", False)) and \
                    self.has_draft
            with self._lock, torch.inference_mode():
                dev = {key: torch.from_numpy(val).to(self.device)
                       for key, val in req.items()}
                nxt = self._prefill_fn(
                    torch.from_numpy(tokens).to(self.device).long(),
                    torch.from_numpy(lengths).to(self.device), taken,
                    torch.from_numpy(write_tables).to(self.device), dev,
                    bool((req["temp"] > 0).any()))
                first = nxt.cpu().numpy()
        except BaseException:
            self._free.extend(taken)
            for taken_pages in page_lists:
                self.pool.release([p for p, _ in taken_pages])
            raise
        self._prefill_seen.add((bb, tb))
        for i, slot in enumerate(taken):
            pages = [pid for pid, _ in page_lists[i]]
            self._slot_pages[slot] = pages
            self._tables[slot, :] = self.pool.n_pages
            self._tables[slot, :len(pages)] = pages
            self._host_len[slot] = lens[i]
            self._active[slot] = True
            self._admit_stamp[slot] = self._admit_seq
            self._admit_seq += 1
            self._temp_np[slot] = req["temp"][i]
            self._draft_np[slot] = req["draft"][i]
        self._active_stale = True
        self._tables_stale = True
        self._prepared = False
        return taken, first

    # -- the decode round --------------------------------------------------
    def prepare_step(self) -> List[int]:
        """Host-side page admission for the NEXT decode round: every
        active slot gets writable pages for the positions this round
        fills (1, or ``draft_tokens + 1`` when speculating). Shared
        pages about to be written are COPY-ON-WRITE re-pointed (one
        indexed copy for all slots at once); pool exhaustion PREEMPTS
        the most recently admitted other slot (its pages free, its
        ticket is the caller's to requeue) until the round fits.
        Returns the preempted slot ids. Idempotent until the next
        admit/decode."""
        if self._prepared:
            return []
        width = self.draft_tokens + 1 if self.has_draft else 1
        preempted: List[int] = []
        cow_src = np.full(self.slots, self.pool.n_pages, np.int64)
        cow_dst = np.full(self.slots, self.pool.n_pages, np.int64)
        order = sorted(np.flatnonzero(self._active),
                       key=lambda s: self._admit_stamp[s])
        for slot in order:
            while self._active[slot]:
                try:
                    self._ensure_writable(int(slot), width, cow_src,
                                          cow_dst)
                    break
                except PagesExhausted:
                    victims = [s for s in np.flatnonzero(self._active)
                               if s != slot]
                    victim = int(max(
                        victims, key=lambda s: self._admit_stamp[s])) \
                        if victims else int(slot)
                    self._preempt(victim, cow_src, cow_dst)
                    preempted.append(victim)
        rows = np.flatnonzero(cow_dst != self.pool.n_pages)
        if rows.size:
            with self._lock, torch.inference_mode():
                self._copy_pages(cow_src[rows], cow_dst[rows])
        self._prepared = True
        return preempted

    def _ensure_writable(self, slot: int, width: int, cow_src,
                         cow_dst) -> None:
        ps = self.page_size
        start = int(self._host_len[slot])
        for pos in range(start, min(start + width,
                                    self.n_blocks * ps)):
            j = pos // ps
            pages = self._slot_pages[slot]
            if j >= len(pages):
                fresh = self.pool.alloc()       # may raise
                pages.append(fresh)
                self._tables[slot, j] = fresh
                self._tables_stale = True
            else:
                dst, src = self.pool.writable(pages[j])  # may raise
                if src is not None:             # COW re-point
                    pages[j] = dst
                    self._tables[slot, j] = dst
                    self._tables_stale = True
                    cow_src[slot] = src
                    cow_dst[slot] = dst

    def _preempt(self, slot: int, cow_src, cow_dst) -> None:
        """Evict a sequence mid-generation (recompute preemption, vLLM's
        policy): all its pages free at once, the slot returns, and the
        caller requeues its ticket to re-prefill prompt + generated so
        far. A COW this round already granted the victim is cancelled
        (the fresh page frees with the rest)."""
        if cow_dst[slot] != self.pool.n_pages:
            cow_src[slot] = self.pool.n_pages
            cow_dst[slot] = self.pool.n_pages
        self.release(slot)
        self.preempted_total += 1

    def _run_round(self, sampling: bool) -> torch.Tensor:
        """The round: the replay of its captured body (captured at the
        body's first round), or the eager body."""
        if not self._graphs_on:
            return self._round_fn(sampling)
        graph = self._graphs.get(sampling)
        if graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # the warm-up rounds write K/V (the draft's too) only at
            # and past each slot's length, which every read masks and
            # the captured round rewrites; the state they advance comes
            # back
            state = self._state
            graph = StepGraph(
                lambda: self._round_fn(sampling), pool=self._pool,
                keep=(state["lengths"], state["tokens"],
                      state["counters"]))
            self._graphs[sampling] = graph
        return graph.replay()

    def decode_many(self) -> Tuple[np.ndarray, np.ndarray]:
        """One decode ROUND for the whole batch. Returns ``(tokens
        [slots, W] int32, counts [slots] int32)``: slot s emitted
        ``tokens[s, :counts[s]]`` this round (W == 1 plain,
        ``draft_tokens + 1`` speculating; counts is 0 for inactive
        slots). Check :attr:`last_finite` before consuming a slot's
        tokens. Calls :meth:`prepare_step` when the caller did not (the
        batcher does, to requeue preempted tickets)."""
        self.prepare_step()
        inject = _fault_mask(self.decode_fault_hook, self._decode_steps,
                             self.slots)
        self._decode_steps += 1
        sampling = bool((self._temp_np[self._active] > 0).any())
        with self._lock, torch.inference_mode():
            if self._active_stale:
                _upload(self._active_dev, self._active)
                self._active_stale = False
            if self._tables_stale:
                _upload(self._tables_dev, self._tables)
                self._tables_stale = False
            if not np.array_equal(inject, self._inject):
                _upload(self._inject_dev, inject)
                self._inject = inject
            # one transfer of the round's int32 block
            host = self._run_round(sampling).cpu().numpy()
        if self.has_draft:
            self._propose_ran = self._verify_ran = True
            k1 = self.draft_tokens + 1
            tokens = host[:, :k1]
            counts = host[:, k1]
            finite = host[:, k1 + 1].astype(bool)
            n_acc = host[:, k1 + 2]
            spec_rows = (self._active & self._draft_np & finite &
                         (self._temp_np <= 0.0))
            self.spec_proposed_total += int(
                spec_rows.sum()) * self.draft_tokens
            self.spec_accepted_total += int(n_acc[spec_rows].sum())
        else:
            self._decode_ran = True
            tokens = host[0][:, None]
            counts = self._active.astype(np.int32)
            finite = host[1].astype(bool)
        # the host length mirror tracks the device clamp exactly
        cap = self.n_blocks * self.page_size
        live = np.flatnonzero(self._active)
        self._host_len[live] = np.minimum(
            self._host_len[live] + counts[live], cap)
        self.last_finite = finite
        self._prepared = False
        return tokens, counts

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int, eos: Optional[int] = None,
                 sampling: Optional[Sequence[Optional[Dict[str, Any]]]]
                 = None) -> List[np.ndarray]:
        """Batch generation (tests and the smoke run; production goes
        through the TokenBatcher). Handles preemption by re-admitting
        the victim's prompt + generated tokens at its resumed sampling
        counter: the backpressure story end to end."""
        sampling = list(sampling) if sampling is not None \
            else [None] * len(prompts)
        slots, first = self.admit(prompts, sampling)
        by_slot = {slot: i for i, slot in enumerate(slots)}
        done = [False] * len(prompts)
        out: List[List[int]] = [[] for _ in prompts]
        for i, tok in enumerate(first):
            out[i].append(int(tok))
            if (eos is not None and int(tok) == eos) or \
                    max_new_tokens <= 1:
                done[i] = True
                self.release(slots[i])
                del by_slot[slots[i]]
        pending: List[int] = []
        while not all(done):
            # preempted sequences wait here until the pool can take
            # their resumed prompt back (the batcher's requeue, in
            # miniature)
            while pending and self.free_slots > 0:
                i = pending[0]
                resumed = np.concatenate(
                    [np.asarray(prompts[i], np.int32).reshape(-1),
                     np.asarray(out[i], np.int32)])
                if len(resumed) >= self.max_len:
                    raise RuntimeError(
                        "preempted sequence no longer fits max_len %d"
                        % self.max_len)
                opts = dict(sampling[i] or {})
                opts["counter"] = len(out[i])
                try:
                    [slot], [tok] = self.admit([resumed], [opts])
                except PagesExhausted:
                    break
                pending.pop(0)
                # the re-prefill draws the NEXT position (prompt +
                # everything emitted) at the ticket's counter: a fresh
                # token, emitted like any other
                out[i].append(int(tok))
                if (eos is not None and out[i][-1] == eos) or \
                        len(out[i]) >= max_new_tokens:
                    done[i] = True
                    self.release(slot)
                else:
                    by_slot[slot] = i
            if not by_slot:
                if pending and not self._active.any():
                    raise PagesExhausted(
                        "pool cannot hold one resumed sequence")
                continue
            for victim in self.prepare_step():
                pending.append(by_slot.pop(victim))
            if not by_slot:
                continue
            tokens, counts = self.decode_many()
            for slot, i in list(by_slot.items()):
                if not self.last_finite[slot]:
                    raise FloatingPointError(
                        "non-finite logits for sequence %d" % i)
                for w in range(int(counts[slot])):
                    out[i].append(int(tokens[slot, w]))
                    if (eos is not None and out[i][-1] == eos) or \
                            len(out[i]) >= max_new_tokens:
                        done[i] = True
                        break
                if done[i] and self._active[slot]:
                    self.release(slot)
                    del by_slot[slot]
        return [np.asarray(o[:max_new_tokens], np.int32) for o in out]

    def warm(self) -> int:
        """Run the whole shape ladder before traffic: every (batch,
        length) prefill bucket the pool can hold, the decode step (or
        the propose + verify pair) and the COW page copy, through the
        real admit/release path (builds the kernels and fills
        PyTorch's allocator cache), and on a CUDA device captures the
        greedy and the sampled round. Returns the shapes added."""
        before = self.compile_count
        cap = min(self.cache_capacity, self.config.seq_len,
                  self.max_len)
        lens = []
        ln = min(self.min_prefill_bucket, self.max_len)
        while ln < cap:
            lens.append(ln)
            ln <<= 1
        lens.append(cap)
        counts = []
        bb = 1
        while bb < self.slots:
            counts.append(bb)
            bb <<= 1
        counts.append(self.slots)
        for n in counts:
            for ln in lens:
                # distinct rows (no sharing): the worst-case page bill
                # for this bucket; skip combos the pool cannot hold
                if n * self.pool.pages_for(ln) > self.pool.n_pages:
                    continue
                prompts = [np.full(ln, 1 + (i % 7), np.int32)
                           for i in range(n)]
                slots, _ = self.admit(prompts)
                for slot in slots:
                    self.release(slot)
            # and once WITH sharing, so the registry paths run warm
            # too (identical prompts share every page)
            slots, _ = self.admit([np.ones(lens[0], np.int32)] * n)
            for slot in slots:
                self.release(slot)
        self.decode_many()
        with self._lock, torch.inference_mode():
            if self._graphs_on:
                # the sampled round's graph too, so that no round of
                # traffic captures (with no slot active, a round
                # changes no state)
                self._run_round(True)
            self._copy_pages(np.zeros(0, np.int64), np.zeros(0, np.int64))
        return self.compile_count - before

    # -- observability -----------------------------------------------------
    def decode_stats(self) -> Dict[str, Any]:
        """Decode-plane gauges for /metrics: the slab plane's set plus
        the page-pool economy (free/shared pages, token occupancy vs
        pool capacity, the configured oversubscription ratio) and the
        speculative acceptance rate."""
        active = self._active
        pool = self.pool
        cap_tokens = pool.capacity_tokens
        resident = int(self._host_len[active].sum()) if active.any() \
            else 0
        stats = {
            "active_sequences": int(active.sum()),
            "slots": self.slots,
            "slot_occupancy": float(active.sum()) / self.slots,
            "cache_capacity": self.cache_capacity,
            "cache_tokens": resident,
            "compile_count": self.compile_count,
            "prefill_buckets": ["%dx%d" % b for b in
                                self.prefill_buckets],
            "page_size": self.page_size,
            "pages_total": pool.n_pages,
            "pages_free": pool.free_pages,
            "pages_shared": pool.shared_pages,
            "token_occupancy": float(resident) / cap_tokens,
            "oversubscription": float(self.slots * self.max_len) /
            cap_tokens,
            "cow_total": pool.cow_total,
            "preempted_total": self.preempted_total,
            "device": str(self.device),
        }
        if self.has_draft:
            proposed = self.spec_proposed_total
            stats["spec_proposed_total"] = proposed
            stats["spec_accepted_total"] = self.spec_accepted_total
            stats["spec_accept_rate"] = (
                self.spec_accepted_total / proposed) if proposed else 0.0
        return stats

    # -- hot swap ----------------------------------------------------------
    def swap_params(self, params: Any) -> None:
        """Replace the TARGET weights (same tree structure, shapes and
        dtypes; the draft is construction state and does not swap), in
        place. Sequences mid-decode continue with the new weights from
        their next step."""
        _swap_lm_weights(self, params)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_trainer(cls, trainer, **kwargs) -> "PagedGenerativeEngine":
        """Engine over anything with ``.config`` / ``.params``."""
        kwargs.setdefault("name", "paged_lm")
        return cls(trainer.config, trainer.params, **kwargs)
