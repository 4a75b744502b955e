"""GenerativeEngine: the KV-cache decode plane on one CUDA device.

Port of ``veles_tpu/serve/engine.py:GenerativeEngine`` (with
``bucket_for`` and ``_validated_swap``), single device: no mesh, no
AOT plan. PyTorch runs eagerly, so the reference's compile cache
becomes a record of the shapes served: ``compile_count`` keeps its
meaning — distinct (batch, length) prefill buckets seen, plus one for
the decode step — and the bucketing discipline that bounds it stays
the same. Every tensor lives on ``self.device``; serving runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from veles_tpu_torch.device import resolve
from veles_tpu_torch.models.transformer import (decode_step,
                                                init_kv_cache,
                                                params_from_numpy,
                                                prefill)


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


def _validated_swap(new_params: Any, current_params: Any, config,
                    device: torch.device) -> Any:
    """Place ``new_params`` on the engine's device and validate it
    against the live tree: same structure, same per-leaf shapes and
    dtypes — the hot-swap guard (a sequence mid-decode continues on
    the new weights from its next step)."""
    new = params_from_numpy(new_params, config, device)
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
    """

    def __init__(self, config, params, *, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 min_prefill_bucket: int = 8,
                 name: str = "generative_lm",
                 device=None) -> None:
        self.device = resolve(device)
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
        self._cache = init_kv_cache(config, self.slots,
                                    self.cache_capacity,
                                    device=self.device)
        self._lengths = torch.zeros(self.slots, dtype=torch.int32,
                                    device=self.device)
        self._last_tokens = torch.zeros(self.slots, dtype=torch.int32,
                                        device=self.device)
        self._active = np.zeros(self.slots, bool)
        #: device mirror of ``_active``, re-uploaded only after
        #: admit/release changed it. None = stale.
        self._active_dev: Optional[torch.Tensor] = None
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
    def _decode_fn(self, inject_nan: Optional[torch.Tensor]):
        logits, self._cache, lengths = decode_step(
            self.params, self._last_tokens, self._cache, self._lengths,
            self.config, active=self._active_mask())
        if inject_nan is not None:
            logits = logits.masked_fill(inject_nan[:, None], float("nan"))
        # the sentinel: one flag per slot back to the host; a
        # non-finite slot keeps its previous last token so the slab
        # state stays well defined until the batcher retires it
        finite = torch.isfinite(logits).all(dim=-1)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self._last_tokens = torch.where(self._active_mask() & finite, nxt,
                                        self._last_tokens)
        self._lengths = lengths
        return nxt, finite

    def _prefill_fn(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    slots: Sequence[int]) -> torch.Tensor:
        logits, prompt = prefill(self.params, tokens, lengths,
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
        bucket pair + at most ONE decode step (the reference's count
        of compiled executables)."""
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
        self._active_dev = None
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
            with torch.inference_mode():
                nxt = self._prefill_fn(
                    torch.from_numpy(tokens).to(self.device).long(),
                    torch.from_numpy(lengths).to(self.device), taken)
                first = nxt.cpu().numpy()
        except BaseException:
            self._free.extend(taken)  # a failed prefill must not leak
            raise
        self._prefill_seen.add((bb, tb))
        for slot in taken:
            self._active[slot] = True
        self._active_dev = None
        return taken, first

    def _active_mask(self) -> torch.Tensor:
        """Device-resident active mask, re-uploaded only after
        admit/release changed the host copy."""
        if self._active_dev is None:
            self._active_dev = torch.from_numpy(self._active).to(
                self.device)
        return self._active_dev

    def decode(self) -> np.ndarray:
        """One decode step for the WHOLE slab (every active sequence
        advances one token; inactive slots are masked). Returns the
        greedy next token per slot ``[slots] int32`` — index it with
        the slot ids :meth:`admit` returned. After each step,
        :attr:`last_finite` says per slot whether its logits were
        finite — the caller retires non-finite slots."""
        inject = None
        if self.decode_fault_hook is not None:
            mask = np.zeros(self.slots, bool)
            for slot in (self.decode_fault_hook(self._decode_steps)
                         or ()):
                mask[int(slot)] = True
            inject = torch.from_numpy(mask).to(self.device)
        self._decode_steps += 1
        with torch.inference_mode():
            nxt, finite = self._decode_fn(inject)
            # one transfer: tokens and flags as int32 [2, slots]
            host = torch.stack([nxt, finite.to(torch.int32)]).cpu().numpy()
        self._decode_ran = True
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
        the real admit/release path (builds the kernels and fills
        PyTorch's allocator cache). Returns the shapes added."""
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
        """Decode-plane gauges for /metrics (host-side snapshot)."""
        lengths = self._lengths.cpu().numpy()
        active = self._active
        return {
            "active_sequences": int(active.sum()),
            "slots": self.slots,
            "slot_occupancy": float(active.sum()) / self.slots,
            "cache_capacity": self.cache_capacity,
            "cache_tokens": int(lengths[active].sum()) if
            active.any() else 0,
            "compile_count": self.compile_count,
            "prefill_buckets": ["%dx%d" % b for b in
                                self.prefill_buckets],
            "device": str(self.device),
        }

    # -- hot swap ----------------------------------------------------------
    def swap_params(self, params: Any) -> None:
        """Replace the weights (same tree structure, shapes and dtypes).
        Sequences mid-decode continue with the new weights from their
        next step."""
        self.params = _validated_swap(params, self.params, self.config,
                                      self.device)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_trainer(cls, trainer, **kwargs) -> "GenerativeEngine":
        """Engine over anything with ``.config`` / ``.params``."""
        kwargs.setdefault("name", "generative_lm")
        return cls(trainer.config, trainer.params, **kwargs)
