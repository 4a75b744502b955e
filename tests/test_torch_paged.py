"""Port parity of the paged serving slice: ``flash_decode_paged`` and
``flash_verify_paged``, ``paged_decode_step`` and ``verify_step``,
``PagedGenerativeEngine`` (greedy, prefix sharing with copy-on-write,
preemption, speculative decoding), the ``TokenBatcher``'s paged half,
the HTTP sampling contract and the sampler, on the CPU against the JAX
package on the same numpy-seeded weights (the reference's small config
of ``tests/test_generative.py``, f32).

Tolerances: attention outputs 1e-5 absolute (f32 sums in another
order: the port gathers 256 // page_size pages per step where the
reference scans one page at a time); logits 1e-4 relative (the bound
the port holds f32 results to); greedy, shared-prefix, preempted and
speculative decoding token for token. Sampled draws come from another
random stream than JAX's (threefry keyed per (seed, counter), Gumbel-
max instead of ``categorical``), so the sampler is held to the
reference's support exactly and to the exact distribution within a
stated total-variation bound.
"""

import functools
import importlib
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu.models import transformer as jtr
from veles_tpu.serve import engine as jengine
from veles_tpu_torch.models import transformer as ttr
from veles_tpu_torch.ops import flash_attention as tfa
from veles_tpu_torch.serve import (ModelRegistry, PagedGenerativeEngine,
                                   ServeServer, TokenBatcher)
from veles_tpu_torch.serve import engine as tengine

# the module (``veles_tpu.ops`` re-exports the function under its name)
jfa = importlib.import_module("veles_tpu.ops.flash_attention")

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

SMALL = dict(vocab=61, embed=32, heads=2, layers=3, seq_len=64)
CONFIG = ttr.TransformerConfig(**SMALL)
JCONFIG = jtr.TransformerConfig(**SMALL, attention_impl="lax")
PARAMS = jtr.init_params(JCONFIG, seed=5)
TPARAMS = ttr.params_from_numpy(PARAMS, CONFIG, "cpu")


def _paged(**kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", 16)
    return PagedGenerativeEngine(CONFIG, PARAMS, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jpaged(n_pages=None):
    """The reference engine, one per pool size for the whole module:
    its executables compile once (greedy decoding does not depend on
    the batch around a sequence, so one engine answers every test)."""
    return jengine.PagedGenerativeEngine(JCONFIG, PARAMS, max_slots=4,
                                         page_size=16, n_pages=n_pages)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SMALL["vocab"], n).astype(np.int32)
            for n in lens]


def _lists(out):
    return [list(map(int, g)) for g in out]


# -- ops: paged attention ----------------------------------------------------

def _pool(rng, n_pages, ps, h, d):
    return [rng.standard_normal((n_pages, ps, h, d)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("impl,ps", [("lax", 8), ("pallas", 8),
                                     ("lax", 128)])
def test_flash_decode_paged_matches_reference(impl, ps):
    """The plain paged decode against the reference's lax scan and its
    Pallas kernel (interpreted), with a scrambled table, sentinels past
    each sequence's last block, a length reaching into a sentinel block
    (both clamp the id and read the last page) and a length of 0."""
    rng = np.random.default_rng(7 + ps)
    b, h, d, n_pages, n_blk = 4, 2, 16, 12, 3
    kp, vp = _pool(rng, n_pages, ps, h, d)
    table = np.full((b, n_blk), n_pages, np.int32)
    table[0, 0] = 4
    table[1] = [7, 1, 10]
    table[2, :2] = [0, 9]
    table[3, 0] = 11
    lengths = np.array([5, 3 * ps, 2 * ps + 1, 0], np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kwargs = {"impl": "lax"} if impl == "lax" else \
        {"impl": "pallas", "interpret": True}
    want = jfa.flash_decode_paged(*map(jnp.asarray, (q, kp, vp, table,
                                                     lengths)), **kwargs)
    got = tfa.flash_decode_paged(*map(torch.from_numpy, (q, kp, vp, table,
                                                         lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert float(got[3].abs().max()) == 0.0


def test_flash_verify_paged_matches_reference():
    rng = np.random.default_rng(8)
    b, k1, ps, h, d, n_pages = 2, 4, 8, 2, 16, 10
    kp, vp = _pool(rng, n_pages, ps, h, d)
    table = np.array([[3, 8, n_pages], [5, 0, 7]], np.int32)
    kv_len = np.array([6, 17], np.int32)[:, None] + 1 + \
        np.arange(k1, dtype=np.int32)
    q = rng.standard_normal((b, k1, h, d)).astype(np.float32)
    want = jfa.flash_verify_paged(*map(jnp.asarray, (q, kp, vp, table,
                                                     kv_len)))
    got = tfa.flash_verify_paged(*map(torch.from_numpy, (q, kp, vp, table,
                                                         kv_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_paged_ops_reject_bad_shapes():
    q = torch.zeros(2, 2, 16)
    pages = torch.zeros(4, 8, 2, 16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[B, H, D\]"):
        tfa.flash_decode_paged(q[None], pages, pages, table, [1, 1])
    with pytest.raises(ValueError, match="page_size"):
        tfa.flash_decode_paged(q, pages, pages[:3], table, [1, 1])
    with pytest.raises(ValueError, match="n_blocks"):
        tfa.flash_decode_paged(q, pages, pages, table[:1], [1, 1])
    with pytest.raises(ValueError, match="needs CUDA"):
        tfa.flash_decode_paged(q, pages, pages, table, [1, 1], impl="cuda")
    with pytest.raises(ValueError, match="K1"):
        tfa.flash_verify_paged(q, pages, pages, table, [[1], [1]])


# -- model: paged decode and verify steps ------------------------------------

def test_paged_decode_and_verify_steps_match_reference():
    """A few paged decode steps and a verify chunk on the same pools and
    tables: logits within 1e-4 of the reference's, the pool's pages
    within 1e-5, and the writes the reference drops (an inactive row)
    never land in a real page."""
    n_pages, ps = 10, 8
    jcache = jtr.init_paged_kv_cache(JCONFIG, n_pages, ps)
    tcache = ttr.init_paged_kv_cache(CONFIG, n_pages, ps, device="cpu")
    assert tuple(tcache["k"].shape) == (3, n_pages + 1, ps, 2, 16)
    # slot 2 is inactive: its table points at real pages it must not
    # write
    tables = np.array([[3, 8, 1, n_pages], [5, 0, 7, 2],
                       [9, 6, n_pages, n_pages]], np.int32)
    active = np.array([True, True, False])
    lengths = np.array([0, 5, 3], np.int32)
    rng = np.random.default_rng(9)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    jdecode = jax.jit(jtr.paged_decode_step, static_argnames="config")
    for step in range(4):
        tokens = rng.integers(1, SMALL["vocab"], 3).astype(np.int32)
        jl, jcache, jlen = jdecode(
            PARAMS, jnp.asarray(tokens), jcache, jnp.asarray(lengths),
            jnp.asarray(tables), config=JCONFIG,
            active=jnp.asarray(active))
        tl, tcache, tlen = ttr.paged_decode_step(
            TPARAMS, torch.from_numpy(tokens), tcache,
            torch.from_numpy(lengths), torch.from_numpy(tables), CONFIG,
            active=torch.from_numpy(active))
        assert rel(tl.numpy(), np.asarray(jl)) <= 1e-4, step
        assert tlen.tolist() == np.asarray(jlen).tolist()
        lengths = np.array(jlen)
    chunk = rng.integers(1, SMALL["vocab"], (3, 3)).astype(np.int32)
    jl, jcache = jtr.verify_step(
        PARAMS, jnp.asarray(chunk), jcache, jnp.asarray(lengths),
        jnp.asarray(tables), JCONFIG, active=jnp.asarray(active))
    tl, tcache = ttr.verify_step(
        TPARAMS, torch.from_numpy(chunk), tcache,
        torch.from_numpy(lengths), torch.from_numpy(tables), CONFIG,
        active=torch.from_numpy(active))
    assert tl.shape == (3, 3, SMALL["vocab"])
    assert rel(tl.numpy(), np.asarray(jl)) <= 1e-4
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, :n_pages].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5,
                                   rtol=0)
        # pages 9 and 6 belong to the inactive slot only: still zero
        assert float(tcache[key][:, [6, 9]].abs().max()) == 0.0


# -- the engine --------------------------------------------------------------

def test_paged_engine_greedy_matches_reference_engine():
    prompts = _prompts(1, (3, 7, 12, 30))
    engine = _paged()
    got = _lists(engine.generate(prompts, 12))
    assert got == _lists(_jpaged().generate(prompts, 12))
    assert engine.free_slots == 4 and engine.active_slots == 0
    assert engine.pool.free_pages == engine.pool.n_pages
    # one (4, 32) prefill bucket + one decode step
    assert engine.compile_count == 2
    assert engine.prefill_buckets == [(4, 32)]


def test_paged_prefix_sharing_and_cow_match_reference():
    """Prompts sharing prefix pages decode as the unshared runs do and as
    the reference does; the consumer's partial tail rides the donor's
    page, so its first decode write goes copy-on-write."""
    donor = (np.arange(32, dtype=np.int32) % 50) + 1   # 2 full pages
    consumer = donor[:20]                              # tail rides pg 1
    engine, jeng = _paged(), _jpaged()
    solo = [_lists(engine.generate([p], 6))[0] for p in (donor, consumer)]
    assert engine.pool.cow_total == 0
    both = _lists(engine.generate([donor, consumer], 6))
    before = jeng.pool.cow_total
    assert both == solo == _lists(jeng.generate([donor, consumer], 6))
    assert engine.pool.shared_hits_total >= 2
    assert engine.pool.cow_total == jeng.pool.cow_total - before >= 1
    assert engine.pool.free_pages == engine.pool.n_pages
    assert engine.decode_stats()["cow_total"] == engine.pool.cow_total


def test_paged_preemption_matches_reference():
    """A 4-page pool (one max-length sequence) under three prompts that
    outgrow it: decode-time exhaustion preempts, the victims re-prefill
    prompt + emitted tokens, and every output is still the reference's
    token for token."""
    prompts = _prompts(3, (10, 12, 9))
    engine, jeng = _paged(n_pages=4), _jpaged(n_pages=4)
    before = jeng.preempted_total
    got = _lists(engine.generate(prompts, 16))
    assert got == _lists(jeng.generate(prompts, 16))
    assert engine.preempted_total == jeng.preempted_total - before > 0
    assert engine.pool.free_pages == 4
    stats = engine.decode_stats()
    assert stats["oversubscription"] == 4.0
    assert stats["preempted_total"] == engine.preempted_total


@pytest.mark.parametrize("seed,lens", [(4, (5, 11)), (1, (3, 7))])
def test_paged_speculative_self_draft_exact_and_fully_accepted(seed, lens):
    """Self-draft (draft == target): output token for token the greedy
    answer, and every proposal verifies. The second case is one where
    the reference accepts 13 of 15: its draft never ingests its K-th
    proposal, so after a fully accepted round it attends one stale
    position; the port's draft ingests it (ROADMAP.md, queue 3)."""
    prompts = _prompts(seed, lens)
    engine = _paged(max_slots=2, draft_params=PARAMS, draft_config=CONFIG,
                    draft_tokens=3)
    got = _lists(engine.generate(prompts, 9, sampling=[{"draft": True}] * 2))
    assert got == _lists(_jpaged().generate(prompts, 9))
    stats = engine.decode_stats()
    assert stats["spec_accept_rate"] == 1.0
    assert stats["spec_proposed_total"] > 0
    # draft propose + target verify + one prefill bucket
    assert engine.compile_count == 3


def test_paged_engine_admission_errors_roll_back():
    engine = _paged(max_slots=2, n_pages=4)
    with pytest.raises(ValueError, match="free slots"):
        engine.admit(_prompts(1, (2, 2, 2)))
    with pytest.raises(ValueError, match="max_len"):
        engine.admit([np.arange(65, dtype=np.int32)])
    with pytest.raises(ValueError, match="sampling entries"):
        engine.admit(_prompts(1, (2,)), sampling=[None, None])
    with pytest.raises(tengine.PagesExhausted):
        engine.admit(_prompts(2, (40, 40)))
    assert engine.free_slots == 2 and engine.pool.free_pages == 4
    assert engine.admit_capacity([40, 40]) == 1
    with pytest.raises(ValueError, match="cannot hold ONE"):
        _paged(n_pages=3)


def test_paged_sampling_deterministic_and_greedy_limits():
    """The same ticket seed draws the same tokens whatever the slot, the
    neighbours or the join order; temp=0 and top_k=1 reduce to greedy;
    a sampled run differs from greedy at this temperature."""
    engine = _paged()
    a, b, c = _prompts(2, (6, 9, 4))
    sa = {"temperature": 0.8, "top_k": 12, "top_p": 0.9, "seed": 123}
    out1 = engine.generate([a, b], 8, sampling=[dict(sa), {"seed": 7}])
    out2 = engine.generate([c, b, a], 8, sampling=[None, None, dict(sa)])
    assert list(out1[0]) == list(out2[2])
    greedy = list(engine.generate([a], 8)[0])
    assert list(out1[0]) != greedy
    for opts in ({"temperature": 0.0, "seed": 99},
                 {"temperature": 0.7, "top_k": 1, "seed": 5}):
        assert list(engine.generate([a], 8, sampling=[opts])[0]) == greedy
    assert greedy == _lists(_jpaged().generate([a], 8))[0]


def test_paged_engine_warm_swap_and_from_trainer():
    from types import SimpleNamespace

    other = jtr.init_params(JCONFIG, seed=11)
    prompt = [np.asarray([4, 9, 2], np.int32)]
    engine = PagedGenerativeEngine.from_trainer(
        SimpleNamespace(config=CONFIG, params=PARAMS), max_slots=2,
        max_len=16, device="cpu")
    assert engine.name == "paged_lm"
    # prefill 2 batch x 2 length buckets, decode, COW copy
    assert engine.warm() == engine.compile_count == 2 * 2 + 2
    assert engine.pool.free_pages == engine.pool.n_pages
    engine.swap_params(other)
    ref = jengine.GenerativeEngine(JCONFIG, other, max_slots=1)
    assert _lists(engine.generate(prompt, 8)) == \
        _lists(ref.generate(prompt, 8))
    assert engine.compile_count == 6
    with pytest.raises(ValueError):
        engine.swap_params(jtr.init_params(
            jtr.TransformerConfig(**dict(SMALL, layers=1)), seed=0))


def test_paged_sentinel_flags_only_the_injected_slot():
    engine = _paged(max_slots=3)
    slots, _ = engine.admit(_prompts(2, (4, 5, 6)))
    engine.decode_fault_hook = lambda step: [slots[1]] if step == 1 else []
    engine.decode_many()
    assert engine.last_finite.all()
    engine.decode_many()
    assert not engine.last_finite[slots[1]]
    assert engine.last_finite[slots[0]] and engine.last_finite[slots[2]]


# -- the batcher and the HTTP front ------------------------------------------

def test_paged_tiny_pool_backpressure_through_batcher():
    """More demand than pages: admission trims at token boundaries,
    decode-time exhaustion preempts and requeues, and every reply is
    still the reference's: backpressure costs throughput, never
    output."""
    engine = _paged(n_pages=4)
    batcher = TokenBatcher(engine, max_queue=16)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
               [2, 7, 1, 8, 2, 8, 1, 8, 2, 8],
               [1, 6, 1, 8, 0, 3, 3, 9, 8, 8],
               [5, 5, 5, 5, 5, 5, 5, 5, 5, 5]]
    # two sampled tickets: a requeued one resumes its own stream
    sampling = [None, {"temperature": 0.9, "seed": 3}, None,
                {"temperature": 1.1, "top_p": 0.8, "seed": 4}]
    results = {}

    def client(i, prompt):
        try:
            results[i] = list(batcher.submit(
                np.asarray(prompt, np.int32), max_tokens=8, timeout=120,
                **(sampling[i] or {})))
        except BaseException as e:  # noqa: BLE001
            results[i] = e

    threads = [threading.Thread(target=client, args=(i, p))
               for i, p in enumerate(prompts)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        batcher.stop()
    rows = [np.asarray(p, np.int32) for p in prompts]
    want = _lists(_jpaged().generate(rows, 8))
    assert [results[i] for i in (0, 2)] == [want[0], want[2]]
    want = _lists(_paged().generate(rows, 8, sampling=sampling))
    assert [results[i] for i in (1, 3)] == [want[1], want[3]]
    assert engine.pool.free_pages == engine.pool.n_pages
    assert engine.active_slots == 0


def test_paged_preempted_sampled_ticket_resumes_its_stream():
    """Sampled sequences preempted mid-stream re-prefill prompt +
    emitted tokens and resume their counters: their tokens equal an
    undisturbed run's on a pool that never preempts."""
    prompts = _prompts(3, (10, 12, 9))
    sampling = [{"temperature": 0.9, "seed": 42}, None,
                {"temperature": 1.2, "top_k": 20, "seed": 7}]
    tight = _paged(n_pages=4)
    got = _lists(tight.generate(prompts, 16, sampling=sampling))
    assert tight.preempted_total > 0
    roomy = _paged()
    assert got == _lists(roomy.generate(prompts, 16, sampling=sampling))
    assert roomy.preempted_total == 0


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_sampling_contract_and_page_gauges():
    """/generate on a paged engine: sampling fields validated to 400,
    seeded requests reproduce, temp=0 is greedy, draft needs a draft
    model; /metrics carries the page gauges in both formats. The slab
    engine still answers 400 to any sampling field."""
    registry = ModelRegistry()
    registry.add_generative("lm", _paged(max_slots=3), max_queue=8)
    registry.add_generative("slab", tengine.GenerativeEngine(
        CONFIG, PARAMS, max_slots=1, device="cpu"))
    server = ServeServer(registry, port=0)
    base = "http://%s:%d" % server.endpoint
    prompt = [3, 1, 4]
    try:
        body = {"prompt": prompt, "max_tokens": 6, "temperature": 0.8,
                "top_k": 12, "top_p": 0.9, "seed": 123}
        code1, doc1 = _post(base + "/generate/lm", dict(body))
        code2, doc2 = _post(base + "/generate/lm", dict(body))
        assert code1 == code2 == 200 and doc1["tokens"] == doc2["tokens"]
        code, doc = _post(base + "/generate/lm", {
            "prompt": prompt, "max_tokens": 6, "temperature": 0.0,
            "seed": 5})
        assert code == 200
        assert doc["tokens"] == _lists(_jpaged().generate(
            [np.asarray(prompt, np.int32)], 6))
        for bad in ({"temperature": -0.5}, {"temperature": "hot"},
                    {"top_k": -3}, {"top_k": 2.5}, {"top_p": 0.0},
                    {"top_p": 1.5}, {"seed": -1}, {"seed": "x"},
                    {"draft": True}, {"draft": "yes"}):
            code, doc = _post(base + "/generate/lm",
                              {"prompt": prompt, "max_tokens": 2, **bad})
            assert code == 400 and "error" in doc, bad
        code, doc = _post(base + "/generate/slab", {
            "prompt": [1, 2], "max_tokens": 2, "temperature": 0.7})
        assert code == 400 and "greedy-only" in doc["error"]
        with urllib.request.urlopen(base + "/metrics") as resp:
            snap = json.loads(resp.read())["lm"]
        for key in ("pages_total", "pages_free", "pages_shared",
                    "token_occupancy", "oversubscription", "cow_total",
                    "preempted_total"):
            assert key in snap, key
        assert snap["pages_free"] == snap["pages_total"] == 12
        with urllib.request.urlopen(
                base + "/metrics?format=prometheus") as resp:
            text = resp.read().decode()
        for name in ("veles_gen_pages_total", "veles_gen_pages_free",
                     "veles_gen_oversubscription", "veles_gen_cow_total",
                     "veles_gen_preempted_total"):
            assert '%s{model="lm"}' % name in text, name
    finally:
        server.stop()


# -- the sampler -------------------------------------------------------------

def test_threefry_matches_jax():
    """The port's counter-based hash is threefry-2x32 bit for bit
    (JAX's own generator and the Random123 known answers)."""
    from jax._src import prng

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, (6, 2), dtype=np.uint64)
    ctrs = rng.integers(0, 2 ** 32, (6, 2), dtype=np.uint64)
    for key, ctr in zip(keys, ctrs):
        want = prng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                  jnp.asarray(ctr, jnp.uint32))
        got = tengine._threefry2x32(*(torch.tensor(int(x)) for x in
                                      (*key, *ctr)))
        assert [int(x) for x in got] == [int(x) for x in want]


def _kept_probs(logits, temp, top_k, top_p):
    """The exact distribution the reference's filter defines: the
    softmax of logits / temp renormalized over the kept tokens."""
    scaled = logits.astype(np.float64) / temp
    order = np.argsort(-scaled)
    desc = scaled[order]
    k = top_k if top_k > 0 else len(desc)
    probs = np.exp(desc - desc.max())
    probs /= probs.sum()
    excl = np.cumsum(probs) - probs
    thresh = desc[excl < top_p].min()
    keep = (scaled >= desc[k - 1]) & (scaled >= thresh)
    keep |= scaled >= desc[0]
    p = np.where(keep, np.exp(scaled - scaled.max()), 0.0)
    return p / p.sum()


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 6, 0.7)])
def test_sampler_support_and_distribution_match_reference(temp, top_k,
                                                          top_p):
    """4000 draws (counters 0..3999) from one row of V = 16 logits, by
    the port and by the reference: the same support, and each empirical
    distribution within total variation 0.06 of the exact renormalized
    softmax. With n = 4000 draws over at most 16 outcomes the expected
    distance is below 0.5 * sqrt(16 / 4000) = 0.032."""
    n, v = 4000, 16
    logits = np.random.default_rng(11).standard_normal(v).astype(
        np.float32) * 0.6
    exact = _kept_probs(logits, temp, top_k, top_p)
    # every kept token has room to show up in 4000 draws
    assert exact[exact > 0].min() > 0.01
    rows = np.broadcast_to(logits, (n, v)).copy()
    args = dict(temp=np.full(n, temp, np.float32),
                top_k=np.full(n, top_k, np.int32),
                top_p=np.full(n, top_p, np.float32),
                seed=np.full(n, 77, np.uint32),
                counter=np.arange(n, dtype=np.int32))
    ref = np.asarray(jengine._sample_tokens(
        jnp.asarray(rows), *(jnp.asarray(args[k]) for k in
                             ("temp", "top_k", "top_p", "seed",
                              "counter"))))
    got = tengine._sample_tokens(
        torch.from_numpy(rows), *(torch.from_numpy(
            args[k].astype(np.int64) if k in ("seed", "counter")
            else args[k]) for k in ("temp", "top_k", "top_p", "seed",
                                    "counter"))).numpy()
    support = set(np.flatnonzero(exact))
    assert set(got.tolist()) == set(ref.tolist()) == support
    for draws in (got, ref):
        emp = np.bincount(draws, minlength=v) / n
        assert 0.5 * np.abs(emp - exact).sum() <= 0.06


def test_sampler_rows_are_independent_of_their_batch():
    """A row's draw is a function of (logits, knobs, seed, counter):
    shuffling the batch shuffles the draws; temp <= 0 rows are the
    argmax."""
    rng = np.random.default_rng(12)
    n, v = 8, 61
    logits = torch.from_numpy(rng.standard_normal((n, v)).astype(
        np.float32))
    temp = torch.tensor([0.8, 0.0, 1.2, 0.5, 0.0, 1.0, 0.9, 2.0])
    top_k = torch.tensor([0, 0, 5, 12, 3, 0, 1, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 0.9, 0.5, 1.0, 0.7, 1.0, 0.95])
    seed = torch.tensor([1, 2, 3, 4, 5, 6, 7, 2 ** 32 - 1])
    counter = torch.tensor([0, 5, 9, 1, 3, 7, 2, 11])
    out = tengine._sample_tokens(logits, temp, top_k, top_p, seed, counter)
    perm = torch.from_numpy(rng.permutation(n))
    shuffled = tengine._sample_tokens(logits[perm], temp[perm],
                                      top_k[perm], top_p[perm], seed[perm],
                                      counter[perm])
    assert torch.equal(shuffled, out[perm])
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    assert torch.equal(out[temp <= 0], greedy[temp <= 0])
    assert out[6] == greedy[6]          # top_k = 1
