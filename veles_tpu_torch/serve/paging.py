"""Paged KV memory management: the block-table page pool.

Port of ``veles_tpu/serve/paging.py``, whole: it is pure Python and
numpy. The slab decode plane (``serve/engine.py:GenerativeEngine``)
sizes its KV cache for the WORST case, ``[L, slots, pow2(max_len), H,
Dh]``, so device memory burns in proportion to a capacity most
sequences never reach. Here KV lives in fixed-size PAGES drawn from one
shared pool (vLLM's PagedAttention, Kwon et al., SOSP 2023), each
sequence owns an ordered *block table* of page ids, and occupancy
tracks the tokens actually resident instead of ``slots x max_len``.
That makes ``max_slots`` oversubscribable, with allocation-failure
backpressure (``PagesExhausted``) at token boundaries when the bet
loses.

Pages are REFCOUNTED so common prompt heads share physical pages:

- admission walks the prompt in page-size chunks and matches each
  chunk against a registry keyed by the *chain* of chunks before it
  (content-prefix identity, not mere content equality: position j's
  K/V depends on every token before it);
- a full-chunk match increfs the donor page instead of allocating;
  the page is not rewritten (its content is already the K/V this
  prefix produces);
- the partial TAIL chunk may also share a donor page whose registered
  chunk extends the tail (the donor's extra positions are masked by
  the consumer's length); the first divergent write then triggers
  copy-on-write (``writable``): the consumer gets a fresh copy and
  the donor keeps its page untouched;
- releasing a sequence decrefs its pages; a page freed to refcount 0
  leaves the registry, so sharing exists exactly among co-resident
  sequences (generated continuations are not registered).

This module is HOST-SIDE bookkeeping only: the device-side page pool,
the block-table attention over it (the K5 kernel) and the decode step
live in ``models/transformer.py``, ``ops/flash_attention.py`` and
``serve/engine.py``. The block table reaches the device as data, never
as a shape.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Default tokens per page. 16 balances internal fragmentation (at
#: most page_size-1 wasted positions per sequence tail) against block
#: table length and per-page bookkeeping; vLLM ships the same default.
DEFAULT_PAGE_SIZE = 16

#: Root of every chunk chain (the empty prefix).
_ROOT = ("page-chain-root",)


class PagesExhausted(RuntimeError):
    """The pool has no free page. Retryable backpressure, not an
    error: the caller sheds or preempts at a token boundary and
    retries once sequences retire."""


def kv_bytes_per_token(layers: int, heads: int, head_dim: int,
                       dtype_bytes: int) -> int:
    """Device bytes one token position costs across the whole stack
    (K and V, every layer)."""
    return 2 * int(layers) * int(heads) * int(head_dim) * \
        int(dtype_bytes)


class PagePool:
    """Refcounted page allocator + prefix-sharing registry.

    ``n_pages`` pages of ``page_size`` token positions each. Size it
    directly, or in HBM terms via :meth:`from_bytes`. NOT thread-safe
    by design: the decode plane's dispatch thread is the only caller
    (the TokenBatcher ownership discipline), so a lock would only
    hide misuse.
    """

    def __init__(self, n_pages: int,
                 page_size: int = DEFAULT_PAGE_SIZE) -> None:
        if n_pages < 1:
            raise ValueError("PagePool needs n_pages >= 1, got %d"
                             % n_pages)
        if page_size < 1 or (page_size & (page_size - 1)):
            raise ValueError("page_size must be a power of two >= 1, "
                             "got %d" % page_size)
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._refcounts = np.zeros(self.n_pages, np.int32)
        # LIFO free list: recently released pages are re-issued first
        # (their HBM is warm in no meaningful sense, but the determin-
        # ism is — tests can predict allocation order)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        #: chain-key -> page id, for FULL prompt chunks only
        self._registry: Dict[tuple, int] = {}
        #: page id -> its chain key (registry eviction on free/write)
        self._page_key: Dict[int, tuple] = {}
        #: prefix chain-key -> chain keys of registered children
        #: (partial-tail donor lookup)
        self._children: Dict[tuple, List[tuple]] = {}
        self.alloc_total = 0
        self.shared_hits_total = 0
        self.cow_total = 0

    @classmethod
    def from_bytes(cls, hbm_bytes: int, page_size: int,
                   token_bytes: int) -> "PagePool":
        """Pool sized in device bytes: as many pages as ``hbm_bytes``
        holds at ``token_bytes`` per position (see
        :func:`kv_bytes_per_token`)."""
        if token_bytes < 1:
            raise ValueError("token_bytes must be >= 1")
        n_pages = int(hbm_bytes) // (int(page_size) * int(token_bytes))
        if n_pages < 1:
            raise ValueError(
                "hbm_bytes %d holds no page (page_size %d x "
                "token_bytes %d)" % (hbm_bytes, page_size, token_bytes))
        return cls(n_pages, page_size)

    @classmethod
    def from_device(cls, page_size: int, token_bytes: int, *,
                    fraction: float = 0.8,
                    reserve_bytes: int = 0) -> "PagePool":
        """Pool sized from the LIVE device budget instead of hand
        arithmetic: reads ``obs.metrics.hbm_runtime_stats()`` (the
        current CUDA device's total memory and the bytes PyTorch's
        allocator holds) and spends ``fraction`` of the headroom,
        minus ``reserve_bytes`` held back for activations: the memory
        plan's peak is the principled value to pass there,
        ``int(engine.plan_footprint()["peak_mb"] * 2**20)``
        (``analysis/memplan.py``). Raises
        ``RuntimeError`` when no CUDA device reports a budget: sizing
        silently from nothing is the hand arithmetic this replaces."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError("fraction must be in (0, 1], got %g"
                             % fraction)
        from veles_tpu_torch.obs.metrics import hbm_runtime_stats
        stats = hbm_runtime_stats()
        limit = stats.get("bytes_limit")
        if not limit:
            raise RuntimeError(
                "device reports no memory budget (stats: %s) - size "
                "the pool explicitly with from_bytes" % sorted(stats))
        headroom = limit - stats.get("bytes_in_use", 0)
        budget = int(headroom * fraction) - int(reserve_bytes)
        return cls.from_bytes(budget, page_size, token_bytes)

    # -- capacity gauges ---------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages referenced by more than one sequence."""
        return int((self._refcounts > 1).sum())

    @property
    def capacity_tokens(self) -> int:
        return self.n_pages * self.page_size

    def refcount(self, page: int) -> int:
        return int(self._refcounts[page])

    def pages_for(self, n_tokens: int) -> int:
        """Pages a sequence of ``n_tokens`` occupies (ceil)."""
        return -(-int(n_tokens) // self.page_size)

    # -- raw alloc/refcount ------------------------------------------------
    def alloc(self) -> int:
        """One fresh private page (refcount 1); raises
        :class:`PagesExhausted` when the pool is dry."""
        if not self._free:
            raise PagesExhausted(
                "page pool exhausted (%d pages of %d tokens all "
                "referenced)" % (self.n_pages, self.page_size))
        page = self._free.pop()
        self._refcounts[page] = 1
        self.alloc_total += 1
        return page

    def incref(self, page: int) -> None:
        if self._refcounts[page] < 1:
            raise ValueError("incref on free page %d" % page)
        self._refcounts[page] += 1

    def decref(self, page: int) -> int:
        """Drop one reference; at zero the page returns to the free
        list and leaves the sharing registry. Returns the remaining
        refcount."""
        if self._refcounts[page] < 1:
            raise ValueError("decref on free page %d" % page)
        self._refcounts[page] -= 1
        remaining = int(self._refcounts[page])
        if remaining == 0:
            self._unregister(page)
            self._free.append(page)
        return remaining

    def release(self, pages: Sequence[int]) -> None:
        """Decref a sequence's whole block list (retirement)."""
        for page in pages:
            self.decref(page)

    # -- prefix sharing ----------------------------------------------------
    def _register(self, key: tuple, page: int) -> None:
        self._registry[key] = page
        self._page_key[page] = key
        self._children.setdefault(key[0], []).append(key)

    def _unregister(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is None:
            return
        self._registry.pop(key, None)
        kids = self._children.get(key[0])
        if kids is not None:
            kids.remove(key)
            if not kids:
                del self._children[key[0]]

    def admit_prompt(self, tokens: Sequence[int]
                     ) -> List[Tuple[int, bool]]:
        """Pages covering ``tokens`` as ``[(page_id, shared), ...]``
        in block order. ``shared=True`` pages already hold this
        prefix's K/V (full-chunk match, or a partial-tail donor whose
        registered chunk extends ours) — the caller must NOT write
        them at prefill; the first divergent decode write goes through
        :meth:`writable` (copy-on-write). Fresh full chunks are
        registered for future sharers. Atomic: on
        :class:`PagesExhausted` every reference this call took is
        rolled back before the raise."""
        toks = [int(t) for t in tokens]
        if not toks:
            raise ValueError("admit_prompt needs a non-empty prompt")
        ps = self.page_size
        n_full = len(toks) // ps
        tail = tuple(toks[n_full * ps:])
        taken: List[Tuple[int, bool]] = []
        prev = _ROOT
        try:
            for j in range(n_full):
                chunk = tuple(toks[j * ps:(j + 1) * ps])
                key = (prev, chunk)
                page = self._registry.get(key)
                if page is not None:
                    self.incref(page)
                    self.shared_hits_total += 1
                    taken.append((page, True))
                else:
                    page = self.alloc()
                    self._register(key, page)
                    taken.append((page, False))
                prev = key
            if tail:
                donor = self._tail_donor(prev, tail)
                if donor is not None:
                    self.incref(donor)
                    self.shared_hits_total += 1
                    taken.append((donor, True))
                else:
                    taken.append((self.alloc(), False))
        except PagesExhausted:
            for page, _ in taken:
                self.decref(page)
            raise
        return taken

    def _tail_donor(self, prev: tuple,
                    tail: tuple) -> Optional[int]:
        """A registered full chunk under the same prefix whose head
        matches our partial tail — its page's leading positions are
        exactly the K/V our prefill would write (the donor's extra
        positions sit beyond our length and are masked)."""
        for key in self._children.get(prev, ()):
            if key[1][:len(tail)] == tail:
                return self._registry.get(key)
        return None

    def writable(self, page: int) -> Tuple[int, Optional[int]]:
        """Make ``page`` safe to write for ONE of its holders.

        Returns ``(dst, src)``: when ``src`` is None the caller may
        write ``dst`` (== ``page``) in place; otherwise ``dst`` is a
        fresh page whose contents must be device-copied from ``src``
        before the write lands (copy-on-write — the caller performs
        the copy, this method only re-points the reference). An
        in-place grant evicts the page from the sharing registry:
        its content is about to diverge from the chunk it advertised.
        Raises :class:`PagesExhausted` (state untouched) when COW
        cannot get a page."""
        if self._refcounts[page] > 1:
            dst = self.alloc()          # may raise; nothing changed yet
            self._refcounts[page] -= 1  # still > 0: donor keeps it
            self.cow_total += 1
            return dst, page
        self._unregister(page)
        return page, None

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "pages_total": self.n_pages,
            "pages_free": self.free_pages,
            "pages_used": self.used_pages,
            "pages_shared": self.shared_pages,
            "page_size": self.page_size,
            "capacity_tokens": self.capacity_tokens,
            "alloc_total": self.alloc_total,
            "shared_hits_total": self.shared_hits_total,
            "cow_total": self.cow_total,
        }
