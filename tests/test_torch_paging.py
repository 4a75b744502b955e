"""Port parity of the page pool: ``veles_tpu_torch.serve.paging`` against
``veles_tpu.serve.paging`` under the same numpy-seeded random sequences
of ``admit_prompt``, ``alloc``, ``writable`` and ``release``, with
shared prefixes and partial tails. The bar is exactness: equal page
ids, refcounts, free lists and counters after every operation, and
``PagesExhausted`` at the same points."""

import numpy as np
import pytest

from veles_tpu.serve import paging as ref
from veles_tpu_torch.serve import paging as port


def _state(pool):
    return (pool._refcounts.tolist(), list(pool._free), pool.free_pages,
            pool.shared_pages, pool.cow_total, pool.shared_hits_total,
            pool.alloc_total, pool.stats())


def _call(pool, name, *args):
    """(result, exhausted?) of one pool call; each package's pool
    raises its own ``PagesExhausted``."""
    module = port if isinstance(pool, port.PagePool) else ref
    try:
        return getattr(pool, name)(*args), False
    except module.PagesExhausted:
        return None, True


@pytest.mark.parametrize("page_size,n_pages", [
    (1, 7), (2, 5), (2, 12), (4, 9), (8, 4), (16, 3), (16, 11)])
def test_page_pool_matches_reference(page_size, n_pages):
    rng = np.random.default_rng(page_size * 100 + n_pages)
    pools = (ref.PagePool(n_pages, page_size),
             port.PagePool(n_pages, page_size))
    # a few base prompts: admitted prefixes of them share full chunks
    # and partial tails
    bases = [rng.integers(1, 6, 5 * page_size + 3).tolist()
             for _ in range(3)]
    seqs = []         # the pages each live "sequence" holds
    exhaustions = 0
    for step in range(400):
        ea = False
        op = rng.choice(["admit", "admit", "alloc", "writable",
                         "release"])
        if op == "admit":
            base = bases[rng.integers(len(bases))]
            n = int(rng.integers(1, len(base) + 1))
            toks = base[:n] + (rng.integers(1, 6, int(rng.integers(0, 3)))
                               .tolist() if rng.random() < 0.3 else [])
            (a, ea), (b, eb) = (_call(p, "admit_prompt", toks)
                                for p in pools)
            assert (a, ea) == (b, eb), step
            if a is not None:
                seqs.append([pid for pid, _ in a])
        elif op == "alloc":
            (a, ea), (b, eb) = (_call(p, "alloc") for p in pools)
            assert (a, ea) == (b, eb), step
            if a is not None:
                seqs.append([a])
        elif op == "writable" and seqs:
            seq = seqs[rng.integers(len(seqs))]
            j = int(rng.integers(len(seq)))
            (a, ea), (b, eb) = (_call(p, "writable", seq[j])
                                for p in pools)
            assert (a, ea) == (b, eb), step
            if a is not None:
                seq[j] = a[0]
        elif op == "release" and seqs:
            seq = seqs.pop(int(rng.integers(len(seqs))))
            for p in pools:
                p.release(seq)
        exhaustions += ea
        assert _state(pools[0]) == _state(pools[1]), (step, op)
        assert pools[0]._registry == pools[1]._registry, step
    # the run reached both pool limits and sharing
    assert exhaustions > 0
    assert pools[1].shared_hits_total > 0
    for seq in seqs:
        for p in pools:
            p.release(seq)
    assert pools[1].free_pages == n_pages
    assert _state(pools[0]) == _state(pools[1])


def test_page_pool_sizing_matches_reference():
    token_bytes = port.kv_bytes_per_token(12, 8, 128, 2)
    assert token_bytes == ref.kv_bytes_per_token(12, 8, 128, 2) == 49152
    assert port.DEFAULT_PAGE_SIZE == ref.DEFAULT_PAGE_SIZE == 16
    for hbm in (10 ** 6, 805306368, 252 * 10 ** 6):
        a = ref.PagePool.from_bytes(hbm, 16, token_bytes)
        b = port.PagePool.from_bytes(hbm, 16, token_bytes)
        assert (a.n_pages, a.capacity_tokens) == (b.n_pages,
                                                  b.capacity_tokens)
    for bad in ((0, 16), (4, 3), (4, 0)):
        with pytest.raises(ValueError):
            port.PagePool(*bad)
    with pytest.raises(ValueError):
        port.PagePool.from_bytes(10, 16, token_bytes)
