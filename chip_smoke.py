#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero
without them, and on any failed phase. Phases, in order:

1. device: the card's name and power limit (``nvidia-smi``), then the
   build of every kernel in ``veles_tpu_torch/ops/csrc`` (parallel
   ``nvcc``, timed, with each kernel's ``ptxas`` registers and spills);
   ``cuobjdump -sass`` counts the Hopper instructions of the flash
   libraries' kernels (``HGMMA``: wgmma; ``UTMALDG``: TMA loads), and
   the phase fails unless the bf16 forward (K1), dK/dV (K2) and dQ (K3)
   kernels hold both and spill nothing; the decode kernels (K4, K5:
   split and merge, every dtype, D and row source) report their
   registers, spills and loads (``LDG.128``: 16-byte global loads), and
   the phase fails unless every split kernel holds them and none
   spills; the LRN kernels (K6, K7: every dtype, lane vector and
   window, summed per dtype and vector) fail the phase where a
   16-byte instance lacks ``LDG.128`` or any instance spills;
2. kernels: each kernel against its plain PyTorch version on the card
   at the main paths' shapes (max errors against stated tolerances),
   with the kernel's and one library call's device time (the
   profiler's kernel time, so the host's launch rate does not enter
   it; the decode kernels K4, K5 and their library calls with the L2
   cache flushed before each call, as a decode step finds its K/V; the
   CUDA-event time of back-to-back calls is kept beside it),
   the plain version's time and the card's lower bound for the work
   (K2 and K3 also summed, beside SDPA's backward, which computes both);
   K1, K2 and K3 give bitwise the same result on a second launch on the
   same inputs: the forward (K1), slab
   decode (K4) and paged decode (K5, the same K/V as K4's slab in a
   scrambled page pool, which must equal K4 bitwise) kernels at the
   serving shapes (K4/K5 logging their chunk counts), the backward
   kernels (K2 dK/dV, K3 dQ) at batch 2 (bf16 and f32, full and
   ragged T), then K1, K2 and K3 at the
   training shape and layout (batch 8, q, k, v strided views of one
   fused QKV projection, SDPA timed on the same views); the LRN forward
   and backward kernels (K6, K7)
   at AlexNet's two LRN shapes at batch 1536 (bf16 and f32) and at a
   ragged row count with an odd C and an even window; the uniform fill
   (K8) bitwise against its plain version at the dropout mask's shape
   and an odd size;
3. serving at full width: the repo's largest LM configuration
   (``bench_transformer.py``: vocab 8192, embed 1024, 8 heads of 128,
   12 layers, seq 2048, bf16) with random seeded weights behind
   ``GenerativeEngine`` -> ``ModelRegistry`` -> ``ServeServer``, eight
   ``POST /generate`` requests (one streaming), the kernels' launch
   counters read around them; then prefill and 32 decode steps timed on
   the engine directly (p50/p99), the decode step a captured CUDA graph
   (the default on the card) and, on an engine of the same weights,
   eager (``cuda_graphs=False``), their tokens equal bitwise, each step
   profiled (its device time and busy share beside the flash-decode
   kernels' share of it); the 8 prompts again over HTTP, each sent once
   the previous one streamed its first token (one prompt an admission,
   so the prefill shapes do not depend on the timing), whose tokens
   phase 13 is held to;
4. parity on the card: greedy tokens through the kernels equal the
   plain path's over 32 steps on a 2-layer f32 copy of the same width;
   the bf16 full-width prefill logits against the plain path;
5. training at full width: the same configuration with
   ``remat="attn"`` and the chunked cross-entropy, batch 8, through
   ``TransformerTrainer`` on one fixed token batch (warm-up steps, a
   timed window, one ``step_many`` of 4), the launch counters read
   around the whole run and around one step; ms per step, tokens/s,
   model TFLOP/s, the device's busy share, peak memory and falling
   losses; the step is one captured CUDA graph (``step_many`` replays
   it K times); then ``GenerativeEngine.from_trainer`` serves the
   trained weights, and an eager trainer from the same seed takes the
   same steps: the same losses bitwise, its times beside;
6. training parity on the card: a 2-layer f32 trainer of the same
   width through the kernels and through the plain path from one
   seed: the first step's gradient of every parameter, then 3 steps'
   losses and parameters, within stated bounds;
7. paged serving at full width: the phase 3 configuration behind
   ``PagedGenerativeEngine`` (8 slots, 16-token pages) -> registry ->
   server, first over a 1024-page pool (the slab's size), then over a
   320-page pool (admission backpressure, preemption): the phase 3
   prompts, one streaming, two sampled, three sharing a 1000-token
   prefix; K5's launches read around each window; every page back at
   the end; a sampled request repeated alone is identical; sampled
   draws from the same f32 logits are equal on the CPU and the card;
   greedy tokens of one batch of the 8 prompts equal the slab
   engine's (with prefix sharing and copy-on-write); a pool that must
   preempt; each engine warmed (``warm()``: the prefill ladder and the
   greedy and sampled round graphs) before its window; 32 paged decode
   rounds, greedy and with 2 sampled slots, timed (p50/p99) and
   profiled, captured and on an eager engine, their tokens equal
   bitwise;
8. paged parity on the card: on a 2-layer f32 copy of full width,
   greedy tokens through K5 equal the plain path's and the slab
   engine's (K4), also on a pool that preempts; speculative decoding
   (a 4-layer target whose last 2 blocks are residual identities, its
   first 2 as the draft, K = 4) equals greedy with acceptance 1.0;
   the same construction at bf16 and full depth (12-layer target,
   2-layer draft, 8 slots, 64 tokens) against greedy, acceptance at
   least 0.7, each mode captured and eager (tokens equal bitwise);
9. classifier training at full width: AlexNet as bench.py trains it
   (``alexnet_fused()``: 1000 classes, 224 x 224 x 3, seed 0; lr 0.01,
   momentum 0.9, weight decay 5e-4; batch 1536; bf16) through
   ``FusedClassifierTrainer`` on one fixed batch (warm-up steps, a
   timed window, one ``step_many`` of 4), every launch counter read
   around the whole run, around one step (exactly 2 each of K6, K7 and
   K8) and around one ``predict`` (2 of K6); ms per step, images/s,
   model TFLOP/s, the device's busy share and time by kernel class,
   peak memory, falling losses; conv1 timed through space-to-depth and
   as a strided conv;
10. classifier parity on the card: the 10-class 64 x 64 AlexNet at
   f32, batch 8, dropout on, through the kernels and through their
   plain versions from one seed (the masks equal bitwise): the first
   step's gradient of every parameter, then 3 steps' losses and
   parameters; then the full-width bf16 forward logits;
11. the classifier served: ``alexnet_fused()`` (seed 0, bf16) through
   ``InferenceEngine.from_specs`` (one captured graph per batch bucket,
   1 to 64) -> ``MicroBatcher`` -> ``ModelRegistry`` -> ``ServeServer``
   ``POST /apply``: ``compile_count`` equal to the number of buckets,
   the probabilities against ``FusedClassifierTrainer.predict`` on the
   same rows, each bucket captured against eager (bitwise) and timed,
   two K6 launches per replay, three concurrent requests over HTTP;
12. the unit graph: a ``Workflow`` of ``AcceleratedUnit``s on
   ``Device()`` (start, a ``Repeater`` loop gated by a ``Bool`` that
   closes after 4 passes, a unit that fills an ``Array`` of [8192, 4096]
   f32 through ``prng.get("smoke").uniform`` (K8), one that sums it on
   the card, the end): the fill bitwise equal to the plain Philox at
   that shape, ``map_read`` equal to the device's values, one K8 launch
   a pass, the unit run order and counters equal to a CPU run of the
   same graph (at [256, 4096]);
13. one card, four tenants of one ``Scheduler``: ``train`` (phase 5's
   trainer, ``step_many(4)`` windows over fixed batches, weight 1),
   ``serve`` (the slab engine of phase 3 behind ``TokenBatcher`` and
   ``ServeServer(scheduler=)``, weight 4; phase 3's 8 prompts of 32
   tokens over HTTP, each sent once the previous one streamed its first
   token, as phase 3 sent them too), ``apply`` (phase 11's AlexNet
   behind ``MicroBatcher``, weight 4, phase 11's requests one after
   another with ``deadline_ms``) and ``graph`` (phase 12's workflow
   through ``attach_workflow``, weight 1), all at once: the LM losses
   bitwise equal to a solo run of the same batches, the greedy tokens
   equal to phase 3's, the ``/apply`` outputs bitwise equal to the
   unscheduled engine's, every tenant served, no thread left after
   ``Scheduler.stop()``; per-tenant accounting, LM tokens/s, the decode
   round and ``/apply`` latencies against their phases alone, memory
   per tenant at set-up, and, in a second window under torch.profiler,
   the tenants' leased device-ms against the card's busy time;
14. the classifier through the unit graph at full width:
   ``AlexNetWorkflow()`` with its own defaults (1000 classes, 224 x 224
   x 3, minibatch 128, lr 0.01, momentum 0.9, weight decay 5e-4, f32
   params, bf16 compute) on ``Device()``, ``SyntheticColorImagesLoader``
   with the dataset cut to 1,024 TRAIN and 256 VALID images (771 MB on
   the card; a cut of how many images exist, not of any width), two
   TRAIN passes through ``wf.run()``: the launches of every minibatch
   (exactly 2 K6, 2 K7 and 2 K8 a TRAIN one, 2 K6 a VALID one), ms per
   TRAIN and VALID minibatch (p50 of the second pass) and images/s
   beside phase 9's fused step, finite and falling losses, the errors
   per epoch, the slowest units, the evaluator's host read, peak memory
   and the device's busy share over 4 single passes under the profiler;
15. unit-graph parity on the card: the 10-class 64 x 64
   ``AlexNetWorkflow`` at f32 (60 TRAIN and 20 VALID images, minibatch
   20, dropout 0.5, one epoch) from one seed, on ``Device()`` through
   the kernels and on ``Device(backend="cpu")`` through the plain
   versions: the dropout masks bitwise, every minibatch's n_err equal
   and loss within bounds, the weights, biases and velocities after
   the epoch within stated bounds.

It prints the per-kernel JSON line and the card line before its last
line, ``{"ok": true, "device": {...}}``; the full record goes to
``chip_smoke_out/chip_smoke.json`` (gitignored).
"""

import gc
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: the card's peak rates (H100 SXM data sheet, dense): FLOP/s by
#: operand type, and HBM bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20

#: stated tolerances, kernel vs plain PyTorch on the same inputs: f32
#: differs only in the order of f32 sums; bf16 rounds p and the output
#: to bf16 at different points of the two sums (a few bf16 ulps of a
#: unit-scale output). The f32 residuals l, m see identical scores up
#: to f32 sum order in both dtypes.
TOL_OUT = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_L_REL = 1e-4
TOL_M = 1e-4
#: backward kernels vs the plain backward, as a share of the plain
#: gradient's largest magnitude: f32 differs in the order of sums of up
#: to T terms; bf16 also rounds p to bf16 before dV where the plain
#: path keeps it in f32 (a few bf16 ulps of the gradient's scale)
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2}

FULL = dict(vocab=8192, embed=1024, heads=8, layers=12, seq_len=2048)
#: the serving phases' prompt lengths (3 and 7); the 1250- and
#: 1500-token prompts extend the 1000-token one (a shared prefix)
PROMPT_LENS = [16, 100, 250, 500, 777, 1000, 1250, 1500]
#: phase 7's sampled requests: index -> knobs
SAMPLED = {2: dict(temperature=0.8, top_k=50, top_p=0.9, seed=101),
           4: dict(temperature=0.8, top_k=50, top_p=0.9, seed=102)}
#: speculative acceptance floor at bf16 (bench_serve.py:582's)
SPEC_ACCEPT_MIN = 0.7
#: the training phase: bench_transformer.py's batch and learning rate
TRAIN_BATCH = 8
TRAIN_LR = 1e-4
#: the classifier phases: bench.py's flagship batch and hyperparameters
CLASSIFIER_BATCH = 1536
CLASSIFIER_HYPER = dict(learning_rate=0.01, momentum=0.9, weight_decay=5e-4)
#: AlexNet's LRN layers: (k, n, alpha, beta)
LRN_SPEC = (2.0, 5, 1e-4, 0.75)
#: f32 operations per element for the bound's operation side (the bytes
#: side bounds all three): K6 squares, sums and scales a window of 5
#: (~16 with the power), K7 does that and a second window (~32); a
#: Philox-4x32-10 block is ~10 rounds of 2 multiplies and 4 other
#: integer ops for 4 elements (~16 each)
LRN_FWD_OPS_PER_ELEM = 16
LRN_BWD_OPS_PER_ELEM = 32
PHILOX_OPS_PER_ELEM = 16
#: K6/K7 vs plain, as a share of the plain output's largest magnitude:
#: the window sums are bitwise the plain versions' (x^2 rounded alike,
#: f32 terms added from the window's low end with round-to-nearest), and
#: the power (base-2 log and exp on the special-function unit, against
#: pow and a division) differs by a few f32 ulps: a few f32 ulps of the
#: result, or where that moves a bf16 rounding (of the result, or of
#: K7's inner), one bf16 ulp (2^-8)
TOL_LRN = {"float32": 1e-5, "bfloat16": 1e-2}
#: phase 10: kernels vs plain at f32 (masks bitwise equal; LRN and
#: cuDNN's sum order differ), as a share of each leaf's scale, and the
#: bf16 full-width logits as a share of the logit scale (an LRN output
#: one bf16 ulp off moves the logits by a few bf16 ulps)
TOL_CLASSIFIER = {"float32": 1e-4, "bfloat16": 2e-2}
#: phase 11: the forward plane's buckets, and its probabilities against
#: the trainer's forward on the same rows (both bf16 through the same
#: kernels; another bucket's batch may take other cuDNN algorithms, so
#: the softmax outputs agree to bf16 rounding of the logits, not bitwise)
APPLY_BUCKETS = [1, 2, 4, 8, 16, 32, 64]
APPLY_SHAPE = (224, 224, 3)
TOL_APPLY = 2e-3


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of one ``fn()`` over ``reps`` launches (CUDA
    events, after a warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


#: the host's pause at the profiler's step boundaries, and the count of
#: device_ms readings that lost records and were taken again
EDGE_PAUSE_S = 0.005
RETAKES = [0]


def device_ms(fn, reps, cold=False):
    """Device time of one ``fn()``: the summed time of the CUDA kernels
    that ``reps`` calls launch (torch.profiler), over ``reps``. The
    profile records one step after a discarded warm-up step of at least
    20 ms with tracing on. The host pauses for ``EDGE_PAUSE_S`` on each
    side of the step boundaries: without the pause the profiler drops
    kernels that ran close to an edge of the recorded step (seen on the
    card as launch counts short by 1 to all of ``reps``). A reading is
    kept only when every kernel's launch count is a multiple of
    ``reps``; one that is not is taken again, three times at most, and
    counted in ``RETAKES``. Unlike CUDA events around back-to-back
    calls, the host's launch rate does not enter it. ``cold``: the L2 cache is flushed before each call (a
    write of twice its 50 MB, whose kernels are left out), as a decode
    step finds a layer's K/V after the other layers'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def kernels(body):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            t0 = time.monotonic()
            while time.monotonic() - t0 < 0.02:
                body()
                torch.cuda.synchronize()
            time.sleep(EDGE_PAUSE_S)
            prof.step()
            time.sleep(EDGE_PAUSE_S)
            body()
            torch.cuda.synchronize()
            time.sleep(EDGE_PAUSE_S)
            prof.step()
        return {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count}

    flush = None
    if cold:
        flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32,
                            device="cuda").zero_

    def timed():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    for _ in range(3):
        skip = set(kernels(flush)) if cold else set()
        seen = [(n, us) for key, (n, us) in kernels(timed).items()
                if key not in skip]
        if seen and (skip or not cold) and \
                all(n % reps == 0 for n, _ in seen):
            return sum(us for _, us in seen) / reps / 1e3
        RETAKES[0] += 1
    raise AssertionError("the profiler lost kernels of %r three times"
                         % (fn,))


#: device kernels by class, from the names the profiler records: the
#: port's own kernels, cuBLAS products, then PyTorch's native kernels
KERNEL_CLASSES = (
    ("flash kernels", ("flash_",)),
    ("LRN and fill kernels", ("lrn_", "uniform_fill")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "cudnn",
                             "convolve", "conv2d")),
    ("pooling", ("pool",)),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized")),
    ("gather and scatter", ("index", "gather", "scatter", "embedding")))


def timed_rounds(fn, n):
    """``n`` calls of ``fn`` (each ends synchronized: the engines hand
    their tokens to the host), each timed on the host clock: (outputs,
    ms per call)."""
    outs, ms = [], []
    for _ in range(n):
        t0 = time.monotonic()
        outs.append(fn())
        ms.append((time.monotonic() - t0) * 1e3)
    return outs, ms


def pcts(ms):
    return dict(p50=float(np.percentile(ms, 50)),
                p99=float(np.percentile(ms, 99)), mean=float(np.mean(ms)))


def profile_device(torch, fn, steps, host_ops=True):
    """Device time by kernel over ``steps`` calls of ``fn`` (which ends
    on the host, synchronized): torch.profiler's CUDA kernel records,
    their sum per call, and the device's busy share of the wall time.
    ``host_ops=False`` records the device only: tracing every host op
    slows a host-bound loop of many small ops (the unit graph) several
    times over. ``None`` when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            fn()
        wall_ms = (time.monotonic() - t0) * 1e3 / steps
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and
            e.self_device_time_total > 0]
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    by_class = {}
    for key, ms, _ in rows:
        cls = next((c for c, marks in KERNEL_CLASSES
                    if any(mark in key for mark in marks)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, by_class=by_class,
                flash_decode_ms=sum(ms for key, ms, _ in rows
                                    if "flash_decode" in key),
                top=[dict(kernel=k[:80], ms=ms, launches=n)
                     for k, ms, n in rows[:8]])


#: SASS instructions counted in phase 1, by their patterns: wgmma, TMA
#: loads, 16-byte global loads
SASS_OPS = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b",
            "LDG.128": r"\bLDG\.\S*128\b"}


def lrn_instance(name):
    """(dtype, lane vector bytes) of an LRN kernel instance's name,
    ``lrn_fwd_kernel<__nv_bfloat16, 8, 5>`` (dtype, elements, window)."""
    dtype, vec = re.search(r"<(\w+), (\d+), \d+>", name).groups()
    return dtype, int(vec) * (2 if "bfloat16" in dtype else 4)


def lrn_needs(name):
    """A 16-byte LRN instance loads 16 bytes at a time."""
    return ("LDG.128",) if lrn_instance(name)[1] == 16 else ()


#: the kernels phase 1 holds to their units: kernel -> (library, entry
#: of ``hopper_smem_bytes`` or None, the SASS ops every instance holds,
#: or a function of the instance's name giving them).
#: The bf16 K1, K2 and K3 run on wgmma and TMA; the decode kernels K4
#: and K5 split the key axis (16-byte loads) and merge the partials;
#: K6 and K7 load a lane's channels 16 bytes at once where the
#: tensors allow it (a narrower instance otherwise).
HOPPER_KERNELS = {
    "flash_fwd_tma_kernel": ("flash_fwd", "flash_fwd", ("HGMMA", "UTMALDG")),
    "flash_bwd_dkv_tma_kernel": ("flash_bwd", "flash_bwd_dkv",
                                 ("HGMMA", "UTMALDG")),
    "flash_bwd_dq_tma_kernel": ("flash_bwd", "flash_bwd_dq",
                                ("HGMMA", "UTMALDG")),
    "flash_decode_split_kernel": ("flash_decode", None, ("LDG.128",)),
    "flash_decode_merge_kernel": ("flash_decode", None, ()),
    "lrn_fwd_kernel": ("lrn", None, lrn_needs),
    "lrn_bwd_kernel": ("lrn", None, lrn_needs)}
#: kernels with an instance per window: phase 1 logs them summed per
#: dtype and lane vector
SUMMED_KERNELS = ("lrn_fwd_kernel", "lrn_bwd_kernel")


def demangle(names):
    """Readable kernel names (``flash_fwd_tma_kernel<128>``) of mangled
    ones, by ``c++filt`` (binutils, beside the compiler nvcc drives)."""
    names = list(names)
    text = subprocess.run(["c++filt"], input="\n".join(names), check=True,
                          capture_output=True, text=True).stdout
    return {name: re.sub(r"^void ", "", plain.replace(
        "(anonymous namespace)::", "").split("(")[0])
        for name, plain in zip(names, text.splitlines())}


def sass_text(lib_path):
    """``cuobjdump -sass`` of a library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout


def sass_counts(lib_path):
    """Per kernel of a library: how many of its SASS instructions are
    each of SASS_OPS (``cuobjdump -sass``)."""
    counts, name = {}, None
    for line in sass_text(lib_path).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op, pattern in SASS_OPS.items():
                if re.search(pattern, line):
                    counts[name][op] += 1
    plain = demangle(counts)
    return {plain[n]: c for n, c in counts.items()}


def ptxas_usage(log):
    """Per kernel of a build log: ptxas's register line and spill line."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
        elif name is not None and ("registers" in line or "spill" in line):
            usage.setdefault(name, []).append(line.split(":")[-1].strip())
    plain = demangle(usage)
    return {plain[n]: lines for n, lines in usage.items()}


def registers(lines):
    """The registers a thread of one kernel uses, from ptxas's lines."""
    return max([int(n) for line in lines
                for n in re.findall(r"Used (\d+) registers", line)] or [0])


def spill_bytes(lines):
    """The spill stores and loads of ptxas's lines for one kernel."""
    return sum(int(n) for line in lines
               for n in re.findall(r"(\d+) bytes spill", line))


def hopper_units(_build, fa):
    """Phase 1's proof that the flash kernels reach the units they were
    written for: for every instance of each of HOPPER_KERNELS, its SASS
    counts, ptxas's registers and spills and, for the bf16 TMA kernels,
    the dynamic shared memory; fails when an instance lacks one of its
    ops or spills, or a library lacks a kernel."""
    record = {}
    for stem, (lib, entry, needs) in HOPPER_KERNELS.items():
        counts = sass_counts(_build.build([lib])[lib])
        usage = ptxas_usage(_build.build_log(lib))
        groups = {}
        for name in sorted(counts):
            if not name.startswith(stem + "<"):
                continue
            c = counts[name]
            lines = usage.get(name, [])
            record[name] = dict(c, ptxas=lines,
                                spill_bytes=spill_bytes(lines))
            smem = ""
            if entry is not None:
                d = int(name[name.index("<") + 1:-1])
                record[name]["dynamic_smem"] = fa.hopper_smem_bytes(entry, d)
                smem = "; dynamic smem %d bytes" % record[name][
                    "dynamic_smem"]
            if stem in SUMMED_KERNELS:
                groups.setdefault(lrn_instance(name), []).append(name)
            else:
                log("  %s: %s; ptxas %s%s" % (
                    name, ", ".join("%d %s" % (c[op], op)
                                    for op in SASS_OPS),
                    "; ".join(lines), smem))
            needs_here = needs(name) if callable(needs) else needs
            if not all(c[op] for op in needs_here):
                raise AssertionError("%s lacks %s" % (name, [
                    op for op in needs_here if not c[op]]))
            if not lines or record[name]["spill_bytes"]:
                raise AssertionError("%s: ptxas reports spills or nothing: "
                                     "%s" % (name, lines))
        for (dtype, vec), names in sorted(groups.items()):
            regs = [registers(usage.get(n, [])) for n in names]
            ldg = [record[n]["LDG.128"] for n in names]
            log("  %s<%s, %d bytes>, %d windows: %d-%d LDG.128, %d-%d "
                "registers, 0 spill bytes" % (
                    stem, dtype, vec, len(names), min(ldg), max(ldg),
                    min(regs), max(regs)))
        if not any(n.startswith(stem + "<") for n in counts):
            raise AssertionError("%s holds no %s" % (lib, stem))
    return record


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check(name, err, tol):
    status = "ok" if err <= tol else "FAIL"
    log("  %-44s max err %.3e (tol %.1e) %s" % (name, err, tol, status))
    if err > tol:
        raise AssertionError("%s: max error %g above %g" % (name, err, tol))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(torch, fa, dev):
    rng = np.random.default_rng(0)
    rows = {}
    h, d = 8, 128

    def randn(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    log("phase 2: kernels vs plain PyTorch (H=%d, D=%d)" % (h, d))
    # K1: causal prefill shapes, full tile and ragged
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for t in (2048, 1000):
            q, k, v = (randn((2, t, h, d), dtype) for _ in range(3))
            o, l, m = fa.flash_attention_fwd(q, k, v, causal=True,
                                             impl="cuda")
            again = fa.flash_attention_fwd(q, k, v, causal=True,
                                           impl="cuda")
            po, pl, pm = fa.flash_attention_fwd(q, k, v, causal=True,
                                                impl="plain")
            torch.cuda.synchronize()
            # a second launch on the same inputs must agree bitwise (no
            # race, no read of unwritten memory)
            if not all(torch.equal(a, b) for a, b in zip((o, l, m), again)):
                raise AssertionError("flash_fwd %s T=%d: two launches on "
                                     "the same inputs differ" % (dn, t))
            del again
            err = float((o.float() - po.float()).abs().max())
            check("flash_fwd %s T=%d O" % (dn, t), err, TOL_OUT[dn])
            check("flash_fwd %s T=%d l (rel)" % (dn, t),
                  float(((l - pl).abs() / pl.abs()).max()), TOL_L_REL)
            check("flash_fwd %s T=%d m" % (dn, t),
                  float((m - pm).abs().max()), TOL_M)
            if dtype is torch.bfloat16 and t == 2048:
                b_ = q.shape[0]
                flops = 4.0 * d * b_ * h * t * (t + 1) / 2
                nbytes = 4 * q.numel() * q.element_size() + 2 * l.numel() * 4
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                ms = device_ms(lambda: fa.flash_fwd_cuda(q, k, v, True), 20)
                plain_ms = time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, causal=True, impl="plain"), 3)
                lib_ms = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                                   20)
                bms, by = bound(flops, nbytes, dn)
                rows["flash_fwd"] = dict(
                    name="flash_fwd", route="cuda",
                    source="veles_tpu_torch/ops/csrc/flash_fwd.cu",
                    replaces="veles_tpu/ops/flash_attention.py:346",
                    shape="q,k,v [2, 2048, 8, 128] bf16, causal",
                    max_abs_err=err, ms=ms, tflops=flops / ms / 1e9,
                    event_ms=time_ms(lambda: fa.flash_fwd_cuda(
                        q, k, v, True), 20),
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms, bitwise_repeat=True)
    # K4: the serving slab [8, 2048, 8, 128], ragged lengths
    b, s = 8, 2048
    lengths = torch.tensor([0, 1, 777, 2048, 1500, 64, 1024, 2000],
                           dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        kc, vc = randn((b, s, h, d), dtype), randn((b, s, h, d), dtype)
        q = randn((b, h, d), dtype)
        out = fa.flash_decode(q, kc, vc, lengths, impl="cuda")
        ref = fa.flash_decode(q, kc, vc, lengths, impl="plain")
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check("flash_decode %s slab [8,2048,8,128]" % dn, err, TOL_OUT[dn])
        if float(out[0].abs().max()) != 0.0:
            raise AssertionError("flash_decode: length-0 row is not zero")
        rows["flash_decode_paged"] = paged_kernel(
            torch, fa, dev, dn, q, kc, vc, lengths, out, rows.get(
                "flash_decode_paged"))
        if dtype is torch.bfloat16:
            live = int(lengths.sum())
            flops = 4.0 * d * h * live
            nbytes = (2 * live * h * d + 2 * b * h * d) * \
                q.element_size() + 4 * b
            mask = (torch.arange(s, device=dev)[None, :] <
                    lengths[:, None])[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            ms = device_ms(lambda: fa.flash_decode_cuda(q, kc, vc, lengths),
                           50, cold=True)
            event_ms = time_ms(lambda: fa.flash_decode_cuda(
                q, kc, vc, lengths), 50)
            plain_ms = time_ms(lambda: fa.flash_decode(
                q, kc, vc, lengths, impl="plain"), 5)
            lib_ms = device_ms(lambda: sdpa(q4, kt, vt, attn_mask=mask), 50,
                               cold=True)
            bms, by = bound(flops, nbytes, dn)
            rows["flash_decode"] = dict(
                name="flash_decode", route="cuda",
                source="veles_tpu_torch/ops/csrc/flash_decode.cu",
                replaces="veles_tpu/ops/flash_attention.py:796",
                shape="q [8, 8, 128], slab [8, 2048, 8, 128] bf16, "
                      "lengths %s" % lengths.tolist(),
                max_abs_err=err, ms=ms, event_ms=event_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)
            log("  flash_decode: %s" % decode_chunks(fa, s, lengths, h))
    backward_kernels(torch, fa, dev, randn, h, d, rows)
    for row in rows.values():
        log("  %s: kernel %.4f ms (back to back %.4f), plain %.4f ms, "
            "library %.4f ms, bound %.4f ms (%s), max abs err %.3e [%s]" % (
                row["name"], row["ms"], row["event_ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"], row["bound_by"],
                row["max_abs_err"], row["shape"]))
    k1 = rows["flash_fwd"]
    log("  flash_fwd: %.1f TFLOP/s; at the training shape kernel %.4f ms "
        "(%.1f TFLOP/s), SDPA %.4f ms, max abs err %.3e [%s]" % (
            k1["tflops"], k1["train_ms"], k1["train_tflops"],
            k1["train_library_ms"], k1["train_max_abs_err"],
            k1["train_shape"]))
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        log("  %s: %.1f TFLOP/s; on contiguous copies of q, k, v: kernel "
            "%.4f ms" % (name, rows[name]["tflops"],
                         rows[name]["ms_contiguous"]))
    log("  flash_bwd_dkv + flash_bwd_dq: %.4f ms, SDPA backward (dQ, dK, "
        "dV) %.4f ms" % (rows["flash_bwd_dq"]["k2_plus_k3_ms"],
                         rows["flash_bwd_dq"]["library_ms"]))
    return rows


def decode_chunks(fa, capacity, lengths, heads):
    """K4/K5's split at a capacity, for the log: the chunks per (head,
    sequence) of the grid, and the blocks with a live chunk (those past
    the length exit at once)."""
    c = fa.DECODE_CHUNK
    live = heads * sum(-(-n // c) for n in lengths.tolist())
    grid = heads * len(lengths) * fa.decode_chunks(capacity)
    return ("chunks of %d keys, %d per (head, sequence); %d of %d blocks "
            "live" % (c, fa.decode_chunks(capacity), live, grid))


def paged_kernel(torch, fa, dev, dn, q, kc, vc, lengths, slab_out, row):
    """K5 on the same K/V as K4's slab, scattered into a pool of
    16-token pages in a random order (every block of every sequence
    has its page; ids past a sequence's last block are the sentinel P):
    checked against the plain paged path, compared bitwise with K4's
    output on the slab, and at bf16 timed beside the plain path, the
    bound and the library yardstick (gather the live pages into a slab,
    then SDPA with a length mask, the two calls together)."""
    b, s, h, d = kc.shape
    ps = 16
    n_blk = s // ps
    n_pages = b * n_blk
    perm = torch.from_numpy(np.random.default_rng(9).permutation(
        n_pages)).to(dev)
    kp = torch.empty((n_pages, ps, h, d), dtype=kc.dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[perm] = kc.reshape(n_pages, ps, h, d)
    vp[perm] = vc.reshape(n_pages, ps, h, d)
    table = perm.reshape(b, n_blk).to(torch.int32)
    live_blocks = (lengths + ps - 1) // ps
    table = torch.where(torch.arange(n_blk, device=dev)[None, :] <
                        live_blocks[:, None], table,
                        torch.full_like(table, n_pages))
    out = fa.flash_decode_paged(q, kp, vp, table, lengths, impl="cuda")
    ref = fa.flash_decode_paged(q, kp, vp, table, lengths, impl="plain")
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    check("flash_decode_paged %s pool [%d,16,8,128]" % (dn, n_pages), err,
          TOL_OUT[dn])
    if float(out[0].abs().max()) != 0.0:
        raise AssertionError("flash_decode_paged: length-0 row is not zero")
    bitwise = bool(torch.equal(out, slab_out))
    log("  flash_decode_paged %s == flash_decode on the slab, bitwise: %s "
        "(max diff %.3e)" % (dn, bitwise,
                             float((out.float() - slab_out.float())
                                   .abs().max())))
    if not bitwise:
        raise AssertionError("flash_decode_paged %s differs from "
                             "flash_decode on the same K/V" % dn)
    if row is not None:          # the bf16 row, made first
        row["bitwise_equal_k4_f32"] = bitwise
        return row
    log("  flash_decode_paged: %s" % decode_chunks(fa, n_blk * ps, lengths,
                                                   h))
    live = int(lengths.sum())
    nbytes = (2 * live * h * d + 2 * b * h * d) * q.element_size() + \
        4 * b + 4 * table.numel()
    bms, by = bound(4.0 * d * h * live, nbytes, dn)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(s, device=dev)[None, :] <
            lengths[:, None])[:, None, None, :]
    safe = table.clamp(max=n_pages - 1).long()

    def library():
        kt = kp[safe].reshape(b, s, h, d).transpose(1, 2)
        vt = vp[safe].reshape(b, s, h, d).transpose(1, 2)
        return sdpa(q[:, :, None], kt, vt, attn_mask=mask)

    return dict(
        name="flash_decode_paged", route="cuda",
        source="veles_tpu_torch/ops/csrc/flash_decode.cu",
        replaces="veles_tpu/ops/flash_attention.py:1060",
        shape="q [8, 8, 128], pool [%d, 16, 8, 128] bf16 (K4's slab in "
              "scrambled pages), block tables [8, %d] with sentinels, "
              "lengths %s" % (n_pages, n_blk, lengths.tolist()),
        max_abs_err=err, bitwise_equal_k4=bitwise,
        ms=device_ms(lambda: fa.flash_decode_paged_cuda(
            q, kp, vp, table, lengths), 50, cold=True),
        event_ms=time_ms(lambda: fa.flash_decode_paged_cuda(
            q, kp, vp, table, lengths), 50),
        plain_ms=time_ms(lambda: fa.flash_decode_paged(
            q, kp, vp, table, lengths, impl="plain"), 5),
        bound_ms=bms, bound_by=by,
        library_ms=device_ms(library, 50, cold=True),
        library_note="gather of the live pages into a slab + SDPA with "
                     "a length mask")


def _bwd_inputs(torch, fa, randn, shape, dtype):
    """q, k, v, dO and the forward's residuals (K1) for K2/K3."""
    q, k, v, do = (randn(shape, dtype) for _ in range(4))
    o, l, m = fa.flash_fwd_cuda(q, k, v, True)
    di = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()
    return q, k, v, do, o, l, m, di


def _check_grads(dn, what, pairs):
    """Each kernel gradient against the plain one, as a share of the
    plain gradient's scale; returns the absolute errors by name."""
    errs = {}
    for name, a, b in pairs:
        errs[name] = float((a.float() - b.float()).abs().max())
        check("flash_bwd %s %s %s (share of scale)" % (dn, what, name),
              errs[name] / float(b.float().abs().max()), TOL_GRAD[dn])
    return errs


def backward_kernels(torch, fa, dev, randn, h, d, rows):
    """K2 and K3 against the plain backward (bf16 and f32, T = 2048 and
    the ragged 1000, batch 2); then K1, K2 and K3 at the training shape
    and layout, checked and timed; adds the K2/K3 rows to ``rows``."""
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for t in (2048, 1000):
            q, k, v, do, o, l, m, di = _bwd_inputs(torch, fa, randn,
                                                   (2, t, h, d), dtype)
            dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True)
            dq = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, True)
            # a second launch on the same inputs must agree bitwise
            # (no race, no read of unwritten memory)
            dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True)
            dq2 = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, True)
            # the plain backward's key tile must divide T (it takes the
            # padded inputs of the autograd core)
            pq, pk, pv = fa._plain_bwd(q, k, v, o, l, m, do, True,
                                       512 if t % 512 == 0 else t, t)
            torch.cuda.synchronize()
            if not (torch.equal(dk, dk2) and torch.equal(dv, dv2) and
                    torch.equal(dq, dq2)):
                raise AssertionError("flash_bwd %s T=%d: two launches on "
                                     "the same inputs differ" % (dn, t))
            _check_grads(dn, "T=%d" % t, (("dq", dq, pq), ("dk", dk, pk),
                                          ("dv", dv, pv)))
    # the training shape and layout: bench_transformer.py's batch 8,
    # q, k, v strided views of one fused [B, T, 3, H, D] projection (as
    # the model's _qkv gives them), dO contiguous (as the core makes it)
    b, t = TRAIN_BATCH, 2048
    qkv = randn((b, t, 3, h, d), torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = randn((b, t, h, d), torch.bfloat16)
    o, l, m = fa.flash_fwd_cuda(q, k, v, True)
    again = fa.flash_fwd_cuda(q, k, v, True)
    po, pl, pm = fa.flash_attention_fwd(q, k, v, causal=True, impl="plain")
    di = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, True)
    again += fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True)
    again += (fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, True),)
    pq, pk, pv = fa._plain_bwd(q, k, v, o, l, m, do, True, 512, t)
    torch.cuda.synchronize()
    what = "[%d, %d, %d, %d] views" % (b, t, h, d)
    if not all(torch.equal(a, b_) for a, b_ in zip((o, l, m, dk, dv, dq),
                                                   again)):
        raise AssertionError("flash kernels at %s: two launches on the "
                             "same inputs differ" % what)
    del again
    err_fwd = float((o.float() - po.float()).abs().max())
    check("flash_fwd bfloat16 %s O" % what, err_fwd, TOL_OUT["bfloat16"])
    check("flash_fwd bfloat16 %s l (rel)" % what,
          float(((l - pl).abs() / pl.abs()).max()), TOL_L_REL)
    check("flash_fwd bfloat16 %s m" % what, float((m - pm).abs().max()),
          TOL_M)
    errs = _check_grads("bfloat16", what, (("dq", dq, pq), ("dk", dk, pk),
                                           ("dv", dv, pv)))
    del po, pl, pm, pq, pk, pv, dk, dv, dq
    views = ("q, k, v strided views of one fused [%d, %d, 3, %d, %d] "
             "projection" % (b, t, h, d))
    pairs = b * h * t * (t + 1) / 2  # causal (query, key) pairs
    train_ms = device_ms(lambda: fa.flash_fwd_cuda(q, k, v, True), 10)
    # SDPA on the same strided views, as [B, H, T, D]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows["flash_fwd"].update(
        train_shape="q,k,v [%d, %d, %d, %d] bf16, causal; %s"
                    % (b, t, h, d, views),
        train_max_abs_err=err_fwd, train_ms=train_ms,
        train_tflops=4.0 * d * pairs / train_ms / 1e9,
        train_event_ms=time_ms(lambda: fa.flash_fwd_cuda(q, k, v, True),
                               10),
        train_library_ms=device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 10),
        train_bitwise_repeat=True)
    row_bytes = q.numel() * q.element_size()
    stat_bytes = l.numel() * 4
    def dkv():
        return fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True)

    def dq_():
        return fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, True)

    ms_dkv, ms_dq = device_ms(dkv, 10), device_ms(dq_, 10)
    event_ms = {"flash_bwd_dkv": time_ms(dkv, 10),
                "flash_bwd_dq": time_ms(dq_, 10)}
    # the same launches on contiguous copies: what the strided layout
    # costs, within one run
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    ms_contiguous = {
        "flash_bwd_dkv": device_ms(lambda: fa.flash_bwd_dkv_cuda(
            qc, kc, vc, do, l, m, di, True), 10),
        "flash_bwd_dq": device_ms(lambda: fa.flash_bwd_dq_cuda(
            qc, kc, vc, do, l, m, di, True), 10)}
    del qc, kc, vc
    plain_ms = time_ms(lambda: fa._plain_bwd(q, k, v, o, l, m, do, True,
                                             512, t), 3)
    # the library yardstick: the backward of causal SDPA alone (its
    # forward ran once, outside the timed launches)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    shape = "q,k,v,dO [%d, %d, %d, %d] bf16, causal; %s, dO contiguous" % (
        b, t, h, d, views)
    # K2: s, dP, dV, dK (four products); reads q, k, v, dO, l, m, Di and
    # writes dK, dV. K3: s, dP, dQ (three); writes dQ.
    for name, ms, n_prod, n_out, err, line in (
            ("flash_bwd_dkv", ms_dkv, 4, 2, max(errs["dk"], errs["dv"]), 509),
            ("flash_bwd_dq", ms_dq, 3, 1, errs["dq"], 539)):
        bms, by = bound(2.0 * d * pairs * n_prod,
                        (4 + n_out) * row_bytes + 3 * stat_bytes, "bfloat16")
        rows[name] = dict(
            name=name, route="cuda",
            source="veles_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces="veles_tpu/ops/flash_attention.py:%d" % line,
            shape=shape, max_abs_err=err, ms=ms,
            tflops=2.0 * d * pairs * n_prod / ms / 1e9,
            event_ms=event_ms[name], bitwise_repeat=True,
            ms_contiguous=ms_contiguous[name], plain_ms=plain_ms,
            plain_note="plain backward computes dQ, dK and dV together",
            bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library_note="SDPA backward alone (dQ, dK, dV together)",
            k2_plus_k3_ms=ms_dkv + ms_dq)


def lrn_fill_kernels(torch, dev):
    """K6/K7 against their plain versions at AlexNet's LRN shapes at
    bench.py's batch (bf16 and f32) and at a ragged row count with an
    odd C and an even window; K8 bitwise against its plain version at
    the dropout mask's shape and an odd size. Each is timed (bf16 for
    the LRN) beside its plain version, one PyTorch call and the card's
    bound; K6/K7 also at f32, the kernels alone (``ms_f32``: twice the
    bytes). Returns the three kernel rows."""
    from veles_tpu_torch.ops import lrn, rng
    import torch.nn.functional as F

    log("phase 2: LRN (K6, K7) and the uniform fill (K8) vs plain PyTorch")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    k, n, alpha, beta = LRN_SPEC
    rows, errs = {}, {"lrn_fwd": 0.0, "lrn_bwd": 0.0}
    f32_ms = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for shape, nn_, al in (((CLASSIFIER_BATCH, 55, 55, 96), n, alpha),
                               ((CLASSIFIER_BATCH, 27, 27, 256), n, alpha),
                               ((1001, 7, 37), 4, 5e-3)):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype) * 3
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            y = lrn.lrn_fwd(x, k, nn_, al, beta, impl="cuda")
            py = lrn.lrn_fwd(x, k, nn_, al, beta, impl="plain")
            torch.cuda.synchronize()
            err = float((y.float() - py.float()).abs().max())
            check("lrn_fwd %s %s n=%d (share of scale)" % (dn, list(shape),
                                                          nn_),
                  err / float(py.float().abs().max()), TOL_LRN[dn])
            del y, py
            dx = lrn.lrn_bwd(x, dy, k, nn_, al, beta, impl="cuda")
            pdx = lrn.lrn_bwd(x, dy, k, nn_, al, beta, impl="plain")
            torch.cuda.synchronize()
            err_b = float((dx.float() - pdx.float()).abs().max())
            check("lrn_bwd %s %s n=%d (share of scale)" % (dn, list(shape),
                                                          nn_),
                  err_b / float(pdx.float().abs().max()), TOL_LRN[dn])
            del dx, pdx
            if dtype is torch.bfloat16 and shape[0] == CLASSIFIER_BATCH:
                errs["lrn_fwd"] = max(errs["lrn_fwd"], err)
                errs["lrn_bwd"] = max(errs["lrn_bwd"], err_b)
                rows[shape[-1]] = _time_lrn(torch, F, lrn, x, dy, shape)
            elif shape[0] == CLASSIFIER_BATCH:
                f32_ms[shape[-1]] = dict(
                    lrn_fwd=device_ms(lambda: lrn.lrn_fwd_cuda(
                        x, k, n, alpha, beta), 10),
                    lrn_bwd=device_ms(lambda: lrn.lrn_bwd_cuda(
                        x, dy, k, n, alpha, beta), 10))
            del x, dy
    layers = {96: "LRN1", 256: "LRN2"}
    out = {}
    for name, line in (("lrn_fwd", 101), ("lrn_bwd", 124)):
        row = dict(rows[96][name], ms_f32=f32_ms[96][name])
        row.update(
            name=name, route="cuda",
            source="veles_tpu_torch/ops/csrc/lrn.cu",
            replaces="veles_tpu/ops/lrn_pallas.py:%d" % line,
            shape="x%s [%d, 55, 55, 96] bf16 (LRN1), k=%g n=%d alpha=%g "
                  "beta=%g; LRN2 [%d, 27, 27, 256] under lrn2" % (
                      ", dy" if name == "lrn_bwd" else "", CLASSIFIER_BATCH,
                      k, n, alpha, beta, CLASSIFIER_BATCH),
            max_abs_err=errs[name],
            lrn2=dict(rows[256][name], layer=layers[256],
                      ms_f32=f32_ms[256][name]),
            library_note="torch.nn.functional.local_response_norm on the "
                         "NCHW view" + (" (its autograd backward)"
                                        if name == "lrn_bwd" else ""))
        for r in (row, row["lrn2"]):
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
        out[name] = row

    # K8: the dropout mask's [B, 4096] and an odd count, bitwise
    for shape, low, high in (((CLASSIFIER_BATCH, 4096), 0.0, 1.0),
                             ((1000003,), -2.0, 3.0)):
        for seed in (0, 2 ** 63 + 11):
            a = rng.uniform_fill(seed, shape, low=low, high=high,
                                 device=dev, impl="cuda")
            b = rng.uniform_fill(seed, shape, low=low, high=high,
                                 device=dev, impl="plain")
            same = bool(torch.equal(a, b))
            log("  uniform_fill %s [%g, %g) seed %d: kernel == plain "
                "bitwise: %s" % (list(shape), low, high, seed, same))
            if not same:
                raise AssertionError("uniform_fill kernel != plain")
    shape = (CLASSIFIER_BATCH, 4096)
    numel = shape[0] * shape[1]
    key = rng._key(12345)
    cuda_gen = torch.Generator(device=dev)
    bms, by = bound(PHILOX_OPS_PER_ELEM * numel, 4 * numel, "float32")
    out["uniform_fill"] = dict(
        name="uniform_fill", route="cuda",
        source="veles_tpu_torch/ops/csrc/rng.cu",
        replaces="veles_tpu/ops/rng.py:44",
        shape="[%d, 4096] f32 (one dropout mask)" % CLASSIFIER_BATCH,
        max_abs_err=0.0, bitwise_equal_plain=True,
        ms=device_ms(lambda: rng.uniform_fill_cuda(numel, key, dev), 50),
        event_ms=time_ms(lambda: rng.uniform_fill_cuda(numel, key, dev),
                         50),
        plain_ms=time_ms(lambda: rng._plain_fill(numel, key, dev, 1.0, 0.0,
                                                 False), 5),
        bound_ms=bms, bound_by=by,
        library_ms=device_ms(lambda: torch.rand(shape, generator=cuda_gen,
                                                device=dev), 50),
        library_event_ms=time_ms(lambda: torch.rand(
            shape, generator=cuda_gen, device=dev), 50),
        library_note="torch.rand on a CUDA generator (Philox too)")
    for row in out.values():
        log("  %s: kernel %.4f ms (back to back %.4f), plain %.4f ms, "
            "library %.4f ms, bound %.4f ms (%s), max abs err %.3e [%s]" % (
                row["name"], row["ms"], row["event_ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"], row["bound_by"],
                row["max_abs_err"], row["shape"]))
        if "lrn2" in row:
            r2 = row["lrn2"]
            log("    share of bound: LRN1 %.3f, LRN2 %.3f"
                % (row["share_of_bound"], r2["share_of_bound"]))
            log("    at LRN2: kernel %.4f ms, plain %.4f ms, library %.4f "
                "ms, bound %.4f ms" % (r2["ms"], r2["plain_ms"],
                                       r2["library_ms"], r2["bound_ms"]))
            log("    kernel at f32: LRN1 %.4f ms, LRN2 %.4f ms"
                % (row["ms_f32"], r2["ms_f32"]))
    return out


def _time_lrn(torch, F, lrn, x, dy, shape):
    """K6 and K7 timed at one bf16 shape beside their plain versions,
    the library call and the bound (bytes: x read and y written; x and
    dy read and dx written)."""
    k, n, alpha, beta = LRN_SPEC
    numel = x.numel()
    res = {}
    xl = x.permute(0, 3, 1, 2)                      # NCHW view
    res["lrn_fwd"] = dict(
        ms=device_ms(lambda: lrn.lrn_fwd_cuda(x, k, n, alpha, beta), 20),
        event_ms=time_ms(lambda: lrn.lrn_fwd_cuda(x, k, n, alpha, beta),
                         20),
        plain_ms=time_ms(lambda: lrn._plain_fwd(x, k, n, alpha, beta), 3),
        library_ms=device_ms(lambda: F.local_response_norm(
            xl, n, alpha, beta, k), 5))
    res["lrn_fwd"]["bound_ms"], res["lrn_fwd"]["bound_by"] = bound(
        LRN_FWD_OPS_PER_ELEM * numel, 2 * numel * x.element_size(),
        "float32")
    xg = xl.detach().requires_grad_()
    out = F.local_response_norm(xg, n, alpha, beta, k)
    dyl = dy.permute(0, 3, 1, 2)
    res["lrn_bwd"] = dict(
        ms=device_ms(lambda: lrn.lrn_bwd_cuda(x, dy, k, n, alpha, beta),
                     20),
        event_ms=time_ms(lambda: lrn.lrn_bwd_cuda(x, dy, k, n, alpha,
                                                  beta), 20),
        plain_ms=time_ms(lambda: lrn._plain_bwd(x, dy, k, n, alpha, beta),
                         3),
        library_ms=device_ms(lambda: torch.autograd.grad(
            out, xg, dyl, retain_graph=True), 5))
    res["lrn_bwd"]["bound_ms"], res["lrn_bwd"]["bound_by"] = bound(
        LRN_BWD_OPS_PER_ELEM * numel, 3 * numel * x.element_size(),
        "float32")
    del out, xg
    return res


# ---------------------------------------------------------------------------
# phase 3: serving at full width through the HTTP front
# ---------------------------------------------------------------------------

def _post(url, doc, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def serving_prompts(vocab):
    """The serving phases' prompts (PROMPT_LENS, seeded): the 1250- and
    1500-token ones are the 1000-token one plus their own tokens."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS[:6]]
    for n in PROMPT_LENS[6:]:
        prompts.append(prompts[5] + rng.integers(1, vocab, n - 1000)
                       .tolist())
    return prompts


def trace_summary(path):
    """What a ``torch.profiler`` Chrome trace (``obs.profile``'s output)
    holds, by category: the span it covers, the device's kernel time,
    and the host's CUDA runtime calls by name (a replay is one
    ``cudaGraphLaunch``; the token read-back a copy and a sync)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    by_cat, runtime = {}, {}
    for e in events:
        cat = e.get("cat", "")
        by_cat[cat] = by_cat.get(cat, 0.0) + e["dur"] / 1e3
        if cat == "cuda_runtime":
            n, ms = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    top = sorted(runtime.items(), key=lambda kv: -kv[1][1])[:6]
    return dict(span_ms=(t1 - t0) / 1e3, kernel_ms=by_cat.get("kernel", 0.0),
                cpu_op_ms=by_cat.get("cpu_op", 0.0),
                runtime_ms=by_cat.get("cuda_runtime", 0.0),
                runtime_top=[dict(name=k, calls=n, ms=ms)
                             for k, (n, ms) in top])


def _profiled_request(url, vocab):
    """One 12-token request through the batcher with the step profiler
    configured (``obs.profile``: steps 2 to 9 of the batcher's
    dispatches, a Chrome trace into chip_smoke_out/profile_serve), and
    the trace summarized: the host profile of captured decode steps."""
    from veles_tpu_torch.obs import profile as obs_profile
    out_dir = os.path.join("chip_smoke_out", "profile_serve")
    shutil.rmtree(out_dir, ignore_errors=True)
    prof = obs_profile.configure("8@2", out_dir)
    try:
        with _post(url, {"prompt": list(range(1, 200)),
                         "max_tokens": 12}) as resp:
            json.loads(resp.read())
    finally:
        obs_profile.configure(None, out_dir)
    stats = prof.stats()
    if stats["failed"] or not stats["done"]:
        raise AssertionError("step profiler: %s" % stats)
    [name] = os.listdir(out_dir)
    summary = trace_summary(os.path.join(out_dir, name))
    log("  step profiler, 8 batcher dispatches (decode steps) of one "
        "request: span %.3f ms, kernels %.3f ms, CUDA runtime calls %.3f ms"
        " (%s)" % (summary["span_ms"], summary["kernel_ms"],
                   summary["runtime_ms"], "; ".join(
                       "%s x%d %.3f ms" % (r["name"], r["calls"], r["ms"])
                       for r in summary["runtime_top"])))
    return summary


def _staggered_generate(url, prompts, n_tok, timeout=600):
    """Each prompt as a streaming ``POST /generate``, the next one sent
    once the previous one streamed its first token: every admission
    holds exactly one prompt, so each sequence's prefill shape (and with
    it its greedy tokens: the decode round's shapes are fixed) does not
    depend on the timing, while the sequences still decode together.
    Returns the tokens per prompt (or the exception)."""
    answers = [None] * len(prompts)
    threads = []
    for i, prompt in enumerate(prompts):
        first = threading.Event()

        def client(i=i, prompt=prompt, first=first):
            try:
                toks, done = [], None
                with _post(url, {"prompt": prompt, "max_tokens": n_tok,
                                 "stream": True}, timeout) as resp:
                    for line in resp:
                        rec = json.loads(line)
                        if "token" in rec:
                            toks.append(rec["token"])
                            first.set()
                        elif "done" in rec:
                            done = rec["tokens"]
                        else:
                            raise RuntimeError(rec)
                if done != toks:
                    raise RuntimeError("stream record mismatch")
                answers[i] = toks
            except BaseException as e:  # noqa: BLE001 — reported by caller
                answers[i] = e
            finally:
                first.set()

        thread = threading.Thread(target=client)
        thread.start()
        threads.append(thread)
        first.wait(timeout)
    for thread in threads:
        thread.join(timeout)
    return answers


def serving_phase(torch, fa, dev, card):
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from veles_tpu_torch.serve import (GenerativeEngine, ModelRegistry,
                                       ServeServer)

    config = TransformerConfig(compute="bfloat16", **FULL)
    log("phase 3: serving %s" % (config,))
    t0 = time.monotonic()
    params = init_params(config, seed=0)
    n_params = sum(int(np.prod(x.shape)) for x in (
        [params["embed"], params["pos"], params["ln_f"]["g"],
         params["ln_f"]["b"]] +
        [leaf for blk in params["blocks"] for leaf in (
            blk["qkv"], blk["proj"], blk["mlp_in"], blk["mlp_out"],
            blk["ln1"]["g"], blk["ln1"]["b"], blk["ln2"]["g"],
            blk["ln2"]["b"])]))
    engine = GenerativeEngine(config, params, max_slots=8, device=dev)
    kv_bytes = sum(x.numel() * x.element_size()
                   for x in engine._cache.values())
    log("  %d params (%.0f MB f32), KV slab %s %.0f MB, set-up %.1f s"
        % (n_params, n_params * 4 / 1e6, tuple(engine._cache["k"].shape),
           kv_bytes / 1e6, time.monotonic() - t0))
    registry = ModelRegistry()
    model = registry.add_generative("lm", engine)
    server = ServeServer(registry, port=0, timeout=600)
    result = {}
    try:
        url = server.url
        # warm-up request (outside the counted window)
        with _post(url, {"prompt": [1, 2, 3], "max_tokens": 2}) as resp:
            json.loads(resp.read())
        plens = PROMPT_LENS
        n_tok = 32
        prompts = serving_prompts(config.vocab)
        answers = [None] * len(prompts)
        snap0 = model.metrics.snapshot()

        def client(i):
            try:
                if i == 0:  # the streaming request
                    toks, done = [], None
                    with _post(url, {"prompt": prompts[i],
                                     "max_tokens": n_tok,
                                     "stream": True}) as resp:
                        for line in resp:
                            rec = json.loads(line)
                            if "token" in rec:
                                toks.append(rec["token"])
                            elif "done" in rec:
                                done = rec["tokens"]
                            else:
                                raise RuntimeError(rec)
                    if done != toks:
                        raise RuntimeError("stream record mismatch")
                    answers[i] = toks
                else:
                    with _post(url, {"prompt": prompts[i],
                                     "max_tokens": n_tok}) as resp:
                        answers[i] = json.loads(resp.read())["tokens"][0]
            except BaseException as e:  # noqa: BLE001 — reported below
                answers[i] = e

        fa.reset_launches()
        t_start = time.monotonic()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.monotonic() - t_start
        launches = dict(fa.LAUNCHES)
        snap1 = model.metrics.snapshot()
        for i, a in enumerate(answers):
            if not isinstance(a, list) or len(a) != n_tok or \
                    not all(0 <= x < config.vocab for x in a):
                raise AssertionError("request %d (prompt %d) answered %r"
                                     % (i, plens[i], a))
        admits = snap1["prefills_total"] - snap0["prefills_total"]
        steps = snap1["decode_steps_total"] - snap0["decode_steps_total"]
        log("  %d requests (prompts %s, %d tokens each, one streaming) "
            "answered in %.3f s: %.1f tokens/s over HTTP; %d prefills, "
            "%d decode steps" % (len(prompts), plens, n_tok, wall,
                                 len(prompts) * n_tok / wall, admits,
                                 steps))
        log("  launches in that window: %s (need >= %d x %d flash_fwd, "
            ">= %d x %d flash_decode)" % (launches, config.layers, admits,
                                          config.layers, steps))
        if launches["flash_fwd"] < config.layers * admits or admits < 1:
            raise AssertionError("flash_fwd launches %d < %d layers x %d "
                                 "prefills" % (launches["flash_fwd"],
                                               config.layers, admits))
        if launches["flash_decode"] < config.layers * steps or steps < 1:
            raise AssertionError("flash_decode launches %d < %d layers x "
                                 "%d steps" % (launches["flash_decode"],
                                               config.layers, steps))
        base = "http://%s:%d" % server.endpoint
        metrics_json = json.loads(_get(base + "/metrics"))
        prom = _get(base + "/metrics?format=prometheus")
        for key in ("tokens_total", "compile_count"):
            if key not in metrics_json["lm"] or \
                    "veles_gen_%s" % key not in prom:
                raise AssertionError("/metrics lacks %s" % key)
        result["host_profile"] = _profiled_request(url, config.vocab)
        # the same prompts admitted one at a time (each sent once the
        # previous one streamed its first token): prefill shapes that do
        # not depend on the timing, so phase 13 can hold its co-tenant
        # tokens to these bitwise
        result["staggered"] = _staggered_generate(url, prompts, n_tok)
        for i, a in enumerate(result["staggered"]):
            if not isinstance(a, list) or len(a) != n_tok:
                raise AssertionError("staggered request %d answered %r"
                                     % (i, a))
        result["http"] = dict(requests=len(prompts), prompt_lens=plens,
                              tokens_each=n_tok, wall_s=wall,
                              tokens_per_s=len(prompts) * n_tok / wall,
                              prefills=admits, decode_steps=steps,
                              launches=launches, answers=answers,
                              metrics=metrics_json["lm"])
    finally:
        server.stop()
    # greedy tokens of one batch of the 8 prompts (the comparison phase 7
    # makes with the paged engine at the same prefill and decode shapes)
    result["batch_tokens"] = [g.tolist() for g in engine.generate(
        [np.asarray(p, np.int32) for p in prompts[::-1]], n_tok)]

    # prefill and decode timed on the engine directly (host clock; the
    # engine hands tokens to the host, so each call ends synchronized):
    # the captured engine above and an eager one of the same weights, on
    # the same batch; their tokens must be equal bitwise
    eager = GenerativeEngine(config, params, max_slots=8, device=dev,
                             cuda_graphs=False)
    del params
    rng = np.random.default_rng(2)
    batch = [rng.integers(1, config.vocab, 1024) for _ in range(8)]
    n_steps = 32
    runs = {}
    for label, eng in (("captured", engine), ("eager", eager)):
        for s_ in eng.admit(batch)[0]:
            eng.release(s_)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        slots, _ = eng.admit(batch)
        prefill_ms = (time.monotonic() - t0) * 1e3
        eng.decode()
        outs, ms = timed_rounds(eng.decode, n_steps)
        prof = profile_device(torch, eng.decode, 8)
        for s_ in slots:
            eng.release(s_)
        runs[label] = dict(prefill_8x1024_ms=prefill_ms, decode_ms=pcts(ms),
                           tokens=[o[slots].tolist() for o in outs],
                           profile=prof)
    if runs["captured"]["tokens"] != runs["eager"]["tokens"]:
        raise AssertionError("captured decode tokens != eager")
    del eager
    for label in runs:
        r = runs[label]
        log("  engine %s: prefill 8 x 1024 tokens %.2f ms; decode step over "
            "8 slots p50 %.3f p99 %.3f mean %.3f ms = %.1f tokens/s [%s]"
            % (label, r["prefill_8x1024_ms"], r["decode_ms"]["p50"],
               r["decode_ms"]["p99"], r["decode_ms"]["mean"],
               8 * 1e3 / r["decode_ms"]["mean"], card))
    log("  captured decode tokens == eager over %d steps: True" % n_steps)
    decode_ms = runs["captured"]["decode_ms"]["mean"]
    prof_decode = runs["captured"]["profile"]
    slots, _ = engine.admit(batch)
    for s_ in slots:
        engine.release(s_)

    def admit_release():
        for s in engine.admit(batch)[0]:
            engine.release(s)

    prof_prefill = profile_device(torch, admit_release, 2)
    for what, prof in (("decode step, captured", prof_decode),
                       ("decode step, eager", runs["eager"]["profile"]),
                       ("prefill 8 x 1024", prof_prefill)):
        if prof is None:
            log("  profile %s: no device time recorded" % what)
            continue
        log("  profile %s: wall %.3f ms, device %.3f ms (busy %.0f%%), "
            "flash decode (K4) %.3f ms; top kernels: %s" % (
                what, prof["wall_ms"], prof["device_ms"],
                100 * prof["busy_share"], prof["flash_decode_ms"],
                "; ".join("%s %.3f ms x%g" % (r["kernel"][:40], r["ms"],
                                              r["launches"])
                          for r in prof["top"][:5])))
    result["engine"] = dict(prefill_8x1024_ms=runs["captured"][
                                "prefill_8x1024_ms"],
                            decode_step_ms=decode_ms,
                            decode_tokens_per_s=8 * 1e3 / decode_ms,
                            peak_mem_bytes=torch.cuda.max_memory_allocated(),
                            profile_decode=prof_decode,
                            profile_prefill=prof_prefill,
                            captured=runs["captured"], eager=runs["eager"])
    return result, launches


# ---------------------------------------------------------------------------
# phase 4: parity on the card, kernels vs plain path
# ---------------------------------------------------------------------------

def parity_phase(torch, dev):
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params,
                                                    params_from_numpy,
                                                    prefill)
    from veles_tpu_torch.serve import GenerativeEngine

    log("phase 4: parity, kernels vs plain path on the card")
    small = dict(FULL, layers=2)
    params = init_params(TransformerConfig(**small), seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, small["vocab"], n).astype(np.int32)
               for n in (10, 100, 700)]
    gens = {}
    for impl in ("cuda", "plain"):
        cfg = TransformerConfig(compute="float32", attention_impl=impl,
                                **small)
        engine = GenerativeEngine(cfg, params, max_slots=4, device=dev)
        gens[impl] = [g.tolist() for g in engine.generate(prompts, 32)]
        del engine
    same = gens["cuda"] == gens["plain"]
    log("  f32 2-layer greedy, 3 prompts x 32 tokens: kernels == plain: "
        "%s" % same)
    if not same:
        raise AssertionError("greedy tokens differ: %r vs %r"
                             % (gens["cuda"], gens["plain"]))
    cfg = TransformerConfig(compute="bfloat16", **FULL)
    tree = params_from_numpy(init_params(cfg, seed=0), cfg, dev)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab, (2, 1024))).to(dev)
    lengths = torch.tensor([1024, 700], device=dev)
    with torch.inference_mode():
        lk, _ = prefill(tree, tokens, lengths, cfg)
        lp, _ = prefill(tree, tokens, lengths, TransformerConfig(
            compute="bfloat16", attention_impl="plain", **FULL))
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    log("  bf16 full width prefill logits [2, 8192]: max |kernel - "
        "plain| %.4e (logit scale %.3f)" % (err, scale))
    if not np.isfinite(err) or err > 0.05 * scale:
        raise AssertionError("bf16 prefill logits off by %g" % err)
    return dict(greedy_equal=same, greedy_tokens=gens["cuda"],
                bf16_prefill_logit_err=err, bf16_logit_scale=scale)


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

def train_flops_per_token(config, n_params):
    """Model FLOPs per trained token, the JAX package's convention
    (``bench_transformer.py:130-138``, kept here as this script's own
    copy): 2 * params for the matmuls plus the full causal attention
    square at 4 * T * E per layer, x3 for forward and backward."""
    return 3 * (2 * n_params +
                4 * config.seq_len * config.embed * config.layers)


def _train_window(torch, fa, trainer, tokens, n_timed=10, k_many=4):
    """The phase 5 step sequence on one trainer: 3 warm-up steps, one
    step with the launch counters read around it, a timed window, one
    step_many, then a profiled step. The counters are set to 0 at the
    start and read at the end of the window."""
    fa.reset_launches()
    losses = [trainer.step(tokens)["loss"] for _ in range(3)]  # warm-up
    torch.cuda.synchronize()
    before = dict(fa.LAUNCHES)
    losses.append(trainer.step(tokens)["loss"])
    one_step = {k: fa.LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n_timed):
        losses.append(trainer.step(tokens)["loss"])
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / n_timed
    t0 = time.monotonic()
    many = trainer.step_many(tokens[None].expand(k_many, -1, -1))
    torch.cuda.synchronize()
    many_ms = (time.monotonic() - t0) * 1e3 / k_many
    launches = dict(fa.LAUNCHES)
    if tuple(many["loss"].shape) != (k_many,):
        raise AssertionError("step_many returned losses of shape %s"
                             % (tuple(many["loss"].shape),))
    losses = torch.stack(losses + list(many["loss"])).tolist()
    prof = profile_device(
        torch, lambda: float(trainer.step(tokens)["loss"]), 2)
    return dict(losses=losses, one_step=one_step, step_ms=step_ms,
                many_ms=many_ms, launches=launches, profile=prof,
                timed_steps=n_timed, step_many_k=k_many)


def training_phase(torch, fa, dev, card):
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerTrainer,
                                                    _ce_chunk, _tree_leaves)
    from veles_tpu_torch.serve import GenerativeEngine

    config = TransformerConfig(compute="bfloat16", remat="attn", **FULL)
    b, t = TRAIN_BATCH, config.seq_len
    log("phase 5: training %s, batch %d, lr %g, ce_chunk %d"
        % (config, b, TRAIN_LR, _ce_chunk(config, t)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    trainer = TransformerTrainer(config, device=dev, seed=0,
                                 learning_rate=TRAIN_LR)
    n_params = sum(x.numel() for x in _tree_leaves(trainer.params))
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, config.vocab,
                                           (b, t + 1))).to(dev)
    setup_s = time.monotonic() - t0

    run = _train_window(torch, fa, trainer, tokens)
    peak = torch.cuda.max_memory_allocated()
    losses, one_step = run["losses"], run["one_step"]
    step_ms = run["step_ms"]
    tokens_per_s = b * t * 1e3 / step_ms
    flops = train_flops_per_token(config, n_params)
    log("  captured: %d params; set-up %.1f s; ms per step %.3f (window of "
        "%d), step_many(%d) %.3f ms per step; %.1f tokens/s; model %.1f "
        "TFLOP/s; peak memory %.2f GB [%s]"
        % (n_params, setup_s, step_ms, run["timed_steps"],
           run["step_many_k"], run["many_ms"], tokens_per_s,
           tokens_per_s * flops / 1e12, peak / 1e9, card))
    log("  losses: %s" % ", ".join("%.4f" % x for x in losses))
    log("  launches around one step: %s (need >= %d each of flash_fwd, "
        "flash_bwd_dkv, flash_bwd_dq)" % (one_step, config.layers))
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if one_step[name] < config.layers:
            raise AssertionError("%s launched %d times in one train step, "
                                 "< %d layers" % (name, one_step[name],
                                                  config.layers))
    if not all(np.isfinite(losses)) or trainer.nonfinite_count:
        raise AssertionError("non-finite training loss: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall on the fixed batch: %s"
                             % losses)
    if len(trainer._graphs) != 1:
        raise AssertionError("%d captured train steps, want 1"
                             % len(trainer._graphs))
    _log_train_profile("captured", run["profile"])

    # serve the trained weights: the engine takes a copy
    engine = GenerativeEngine.from_trainer(trainer, max_slots=2,
                                           device=dev)
    if engine.params["embed"].data_ptr() == \
            trainer.params["embed"].data_ptr():
        raise AssertionError("the engine aliases the trainer's weights")
    prompts = [rng.integers(1, config.vocab, n).astype(np.int32)
               for n in (12, 300)]
    gen = [g.tolist() for g in engine.generate(prompts, 8)]
    if any(len(g) != 8 or not all(0 <= x < config.vocab for x in g)
           for g in gen):
        raise AssertionError("generation from the trained weights: %r"
                             % (gen,))
    log("  served the trained weights: greedy tokens %s" % gen)
    del engine, trainer
    torch.cuda.empty_cache()

    # the same steps eagerly, from the same seed: the same losses
    eager = TransformerTrainer(config, device=dev, seed=0,
                               learning_rate=TRAIN_LR, cuda_graphs=False)
    erun = _train_window(torch, fa, eager, tokens)
    del eager
    equal = erun["losses"] == losses
    log("  eager: ms per step %.3f, step_many(%d) %.3f ms per step, %.1f "
        "tokens/s; losses equal to the captured run's bitwise: %s [%s]"
        % (erun["step_ms"], erun["step_many_k"], erun["many_ms"],
           b * t * 1e3 / erun["step_ms"], equal, card))
    _log_train_profile("eager", erun["profile"])
    if not equal:
        raise AssertionError("eager losses %s != captured %s"
                             % (erun["losses"], losses))
    return dict(batch=b, n_params=n_params, learning_rate=TRAIN_LR,
                setup_s=setup_s, step_ms=step_ms,
                timed_steps=run["timed_steps"],
                step_many_k=run["step_many_k"],
                step_many_ms_per_step=run["many_ms"],
                tokens_per_s=tokens_per_s,
                model_tflops=tokens_per_s * flops / 1e12,
                flops_per_token=flops, peak_mem_bytes=peak,
                losses=losses, launches_one_step=one_step,
                profile=run["profile"], generated=gen,
                eager=dict(step_ms=erun["step_ms"],
                           step_many_ms_per_step=erun["many_ms"],
                           tokens_per_s=b * t * 1e3 / erun["step_ms"],
                           profile=erun["profile"],
                           losses_equal=equal)), run["launches"]


def _log_train_profile(label, prof):
    if prof is None:
        log("  profile train step (%s): no device time recorded" % label)
        return
    log("  profile train step (%s): wall %.3f ms, device %.3f ms (busy "
        "%.0f%%); top kernels: %s" % (
            label, prof["wall_ms"], prof["device_ms"],
            100 * prof["busy_share"],
            "; ".join("%s %.3f ms x%g" % (r["kernel"][:40], r["ms"],
                                          r["launches"])
                      for r in prof["top"][:6])))
    log("  train step device time by class: %s" % "; ".join(
        "%s %.3f ms" % kv for kv in sorted(
            prof["by_class"].items(), key=lambda kv: -kv[1])))


# ---------------------------------------------------------------------------
# phase 6: training parity on the card, kernels vs plain path
# ---------------------------------------------------------------------------

def train_parity_phase(torch, dev):
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerTrainer,
                                                    _loss, _tree_leaves)

    small = dict(FULL, layers=2)
    lr, n_steps = 1e-3, 3
    log("phase 6: training parity, 2-layer f32 at full width, batch 2, "
        "%d steps, lr %g" % (n_steps, lr))
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.integers(
        0, small["vocab"], (2, small["seq_len"] + 1))).to(dev)
        for _ in range(n_steps)]
    runs = {}
    for impl in ("cuda", "plain"):
        cfg = TransformerConfig(compute="float32", attention_impl=impl,
                                **small)
        trainer = TransformerTrainer(cfg, device=dev, seed=3,
                                     learning_rate=lr)
        # the first step's gradients, before Adam (which moves every
        # parameter by about lr whatever its gradient's scale) runs
        x = batches[0]
        grads = [g.detach() for g in torch.autograd.grad(
            _loss(trainer.params, x[:, :-1], x[:, 1:], cfg),
            _tree_leaves(trainer.params))]
        losses = [float(trainer.step(x)["loss"]) for x in batches]
        runs[impl] = (losses, grads, _tree_leaves(trainer.params))
        del trainer
    (lk, gk, pk), (lp, gp, pp) = runs["cuda"], runs["plain"]
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(lk, lp))
    # each leaf's largest error over its own largest magnitude
    grad_err = max(float((a - c).abs().max() /
                         c.abs().max().clamp_min(1e-30))
                   for a, c in zip(gk, gp))
    param_err = max(float((a - c).detach().abs().max())
                    for a, c in zip(pk, pp))
    log("  losses kernels %s, plain %s" % (lk, lp))
    # f32 on both sides: the gradients and losses differ in sum order
    # only (the bound the CPU tests hold the port to against the JAX
    # package). The gradient check is what holds the kernels: Adam's
    # first steps move each parameter by about +-lr whatever its
    # gradient's size, so 2 lr per step bounds the parameters of any
    # two runs and only guards against a diverged one.
    check("train grads step 1, kernels vs plain (share of each leaf's "
          "scale)", grad_err, TOL_GRAD["float32"])
    check("train loss, kernels vs plain (relative)", loss_err, 1e-4)
    check("train params, kernels vs plain (2 lr per step)", param_err,
          2 * lr * n_steps)
    return dict(losses_kernels=lk, losses_plain=lp, loss_rel_err=loss_err,
                grad_rel_err=grad_err, param_max_err=param_err, lr=lr,
                steps=n_steps)



# ---------------------------------------------------------------------------
# phase 7: paged serving at full width through the HTTP front
# ---------------------------------------------------------------------------

def _http_window(torch, fa, url, model, prompts, n_tok):
    """The phase 7 requests, all at once: 0 streams, SAMPLED sample,
    the rest are greedy. Returns (answers, wall s, launches, snapshot
    deltas), the launch counters set to 0 just before."""
    answers = [None] * len(prompts)

    def client(i):
        doc = dict(prompt=prompts[i], max_tokens=n_tok, **SAMPLED.get(i, {}))
        try:
            if i == 0:
                toks, done = [], None
                with _post(url, dict(doc, stream=True)) as resp:
                    for line in resp:
                        rec = json.loads(line)
                        if "token" in rec:
                            toks.append(rec["token"])
                        elif "done" in rec:
                            done = rec["tokens"]
                        else:
                            raise RuntimeError(rec)
                if done != toks:
                    raise RuntimeError("stream record mismatch")
                answers[i] = toks
            else:
                with _post(url, doc) as resp:
                    answers[i] = json.loads(resp.read())["tokens"][0]
        except BaseException as e:  # noqa: BLE001 — reported below
            answers[i] = e

    snap0 = model.metrics.snapshot()
    fa.reset_launches()
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.monotonic() - t0
    launches = dict(fa.LAUNCHES)
    # the engine's gauges, read while its batcher is idle
    snap1 = model.metrics.snapshot(engine=model.engine)
    for i, a in enumerate(answers):
        if not isinstance(a, list) or len(a) != n_tok or \
                not all(0 <= x < FULL["vocab"] for x in a):
            raise AssertionError("request %d answered %r" % (i, a))
    delta = {k: snap1[k] - snap0[k] for k in (
        "prefills_total", "decode_steps_total", "tokens_total")}
    return answers, wall, launches, delta, snap1


def _agreement(a, b):
    """Tokens of equal position and value, over all replies."""
    return sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def paged_serving_phase(torch, fa, dev, card, slab):
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params, prefill)
    from veles_tpu_torch.serve import (ModelRegistry, PagedGenerativeEngine,
                                       ServeServer)
    from veles_tpu_torch.serve.engine import _sample_tokens

    config = TransformerConfig(compute="bfloat16", **FULL)
    log("phase 7: paged serving %s, 8 slots, 16-token pages" % (config,))
    params = init_params(config, seed=0)
    prompts = serving_prompts(config.vocab)
    n_tok = 32
    greedy_idx = [i for i in range(len(prompts)) if i not in SAMPLED]
    result, launches_main = {}, None
    for label, n_pages in (("pool 1024", 1024), ("pool 320", 320)):
        engine = PagedGenerativeEngine(config, params, max_slots=8,
                                       page_size=16, n_pages=n_pages,
                                       device=dev)
        # the prefill ladder and both round graphs (greedy, sampled)
        # before traffic: no round in the window captures
        t0 = time.monotonic()
        engine.warm()
        log("  %s: warm (prefill ladder, %d round graphs) %.1f s"
            % (label, len(engine._graphs), time.monotonic() - t0))
        kv_bytes = sum(x.numel() * x.element_size()
                       for x in engine._cache.values())
        registry = ModelRegistry()
        model = registry.add_generative("lm", engine)
        server = ServeServer(registry, port=0, timeout=600)
        try:
            url = server.url
            with _post(url, {"prompt": [1, 2, 3], "max_tokens": 2}) as r:
                json.loads(r.read())                  # warm-up
            answers, wall, launches, delta, snap = _http_window(
                torch, fa, url, model, prompts, n_tok)
            steps = delta["decode_steps_total"]
            log("  %s (%.0f MB of K/V): 8 requests in %.3f s, %.1f tokens/s "
                "over HTTP; %d prefills, %d decode rounds, decode ms p50 "
                "%.3f p99 %.3f; cow %d, preempted %d, shared pages now "
                "%d; launches %s [%s]" % (
                    label, kv_bytes / 1e6, wall, len(prompts) * n_tok / wall,
                    delta["prefills_total"], steps, snap["decode_ms"]["p50"],
                    snap["decode_ms"]["p99"], snap["cow_total"],
                    snap["preempted_total"], snap["pages_shared"], launches,
                    card))
            if launches["flash_decode_paged"] != config.layers * steps or \
                    steps < 1:
                raise AssertionError(
                    "flash_decode_paged launches %d != %d layers x %d "
                    "rounds" % (launches["flash_decode_paged"],
                                config.layers, steps))
            if launches["flash_fwd"] < config.layers * \
                    delta["prefills_total"] or launches["flash_decode"]:
                raise AssertionError("launches %s" % launches)
            base = "http://%s:%d" % server.endpoint
            prom = _get(base + "/metrics?format=prometheus")
            for name in ("pages_free", "pages_shared", "cow_total",
                         "preempted_total", "oversubscription"):
                if 'veles_gen_%s{model="lm"}' % name not in prom:
                    raise AssertionError("/metrics lacks %s" % name)
            # a sampled request repeated alone gives its tokens again
            i = min(SAMPLED)
            doc = dict(prompt=prompts[i], max_tokens=n_tok, **SAMPLED[i])
            alone = []
            for _ in range(2):
                with _post(url, doc) as resp:
                    alone.append(json.loads(resp.read())["tokens"][0])
            if alone[0] != alone[1]:
                raise AssertionError("seeded request not reproduced: %r"
                                     % alone)
        finally:
            server.stop()
        if engine.pool.free_pages != n_pages or engine.active_slots:
            raise AssertionError("%s: %d of %d pages back, %d active"
                                 % (label, engine.pool.free_pages, n_pages,
                                    engine.active_slots))
        result[label] = dict(
            n_pages=n_pages, kv_bytes=kv_bytes, wall_s=wall,
            tokens_per_s=len(prompts) * n_tok / wall, **delta,
            decode_ms=snap["decode_ms"], cow_total=snap["cow_total"],
            preempted_total=snap["preempted_total"], launches=launches,
            answers=answers, sampled_repeat_equal=True,
            sampled_in_window_vs_alone=answers[i] == alone[0])
        if launches_main is None:
            launches_main = launches
            roomy = engine
        else:
            del engine
    # greedy agreement over HTTP (bf16: a prefill batch of another shape
    # may round differently, so this is reported; the exact checks are
    # the one-batch comparison below and phase 8's at f32)
    slab_http = [slab["http"]["answers"][i] for i in greedy_idx]
    for label in result:
        mine = [result[label]["answers"][i] for i in greedy_idx]
        result[label]["greedy_agree_slab_http"] = _agreement(mine, slab_http)
    result["greedy_agree_pools_http"] = _agreement(
        *([result[lb]["answers"][i] for i in greedy_idx] for lb in result))
    log("  greedy tokens equal over HTTP: pool 1024 vs slab %d, pool 320 vs "
        "slab %d, pool 1024 vs pool 320 %d, of %d" % (
            result["pool 1024"]["greedy_agree_slab_http"],
            result["pool 320"]["greedy_agree_slab_http"],
            result["greedy_agree_pools_http"], len(greedy_idx) * n_tok))

    # one batch of the 8 prompts (longest first: the 1000-token prompt's
    # tail rides a donor page and goes copy-on-write) on the 1024-page
    # engine: the slab engine's tokens, at the same shapes
    rows = [np.asarray(p, np.int32) for p in prompts[::-1]]
    cow0 = roomy.pool.cow_total
    batch = [g.tolist() for g in roomy.generate(rows, n_tok)]
    if batch != slab["batch_tokens"]:
        raise AssertionError("paged greedy batch != slab engine's")
    if roomy.pool.cow_total == cow0 or not roomy.pool.shared_hits_total:
        raise AssertionError("no prefix sharing / copy-on-write")
    log("  one batch of the 8 prompts: paged == slab engine token for "
        "token (%d COW copies, %d shared-page hits)"
        % (roomy.pool.cow_total - cow0, roomy.pool.shared_hits_total))
    # a pool that must preempt: the batch's own pages (216 with the shared
    # prefix) plus 8, where the 32 tokens need about 17 more
    tight = PagedGenerativeEngine(config, params, max_slots=8, page_size=16,
                                  n_pages=224, device=dev)
    tight_tokens = [g.tolist() for g in tight.generate(rows, n_tok)]
    if not tight.preempted_total or tight.pool.free_pages != 224:
        raise AssertionError("224-page pool: %d preempted, %d pages back"
                             % (tight.preempted_total,
                                tight.pool.free_pages))
    agree = _agreement(tight_tokens, batch)
    log("  224-page pool: %d preemptions; tokens equal to the unpreempted "
        "batch: %d of %d (a re-prefill recomputes K/V in another shape)"
        % (tight.preempted_total, agree, len(rows) * n_tok))
    result["batch"] = dict(equal_slab=True, cow=roomy.pool.cow_total - cow0,
                           preempting_pool=224,
                           preempted=tight.preempted_total,
                           preempted_agree=agree)
    del tight

    # the sampler on the CPU and on the card, from the same f32 logits
    tok = torch.zeros((8, 2048), dtype=torch.long, device=dev)
    for r, p in enumerate(prompts):
        tok[r, :len(p)] = torch.tensor(p)
    lengths = torch.tensor([len(p) for p in prompts], device=dev)
    with torch.inference_mode():
        logits, _ = prefill(roomy.params, tok, lengths, config)
    n_ctr = 16
    knobs = [torch.tensor(x) for x in zip(*(
        (0.8, 50, 0.9, 101 + r, c) for c in range(n_ctr)
        for r in range(8)))]
    rep_logits = logits.repeat(n_ctr, 1)
    card_draws = _sample_tokens(rep_logits, *(x.to(dev) for x in knobs))
    cpu_draws = _sample_tokens(rep_logits.cpu(), *knobs)
    if not torch.equal(card_draws.cpu(), cpu_draws):
        raise AssertionError("sampled tokens differ between CPU and card")
    log("  sampler: %d draws from the same f32 logits equal on the CPU and "
        "the card" % cpu_draws.numel())
    result["sampler_cpu_card_equal"] = True

    # a paged decode round timed and profiled, as phase 3 times the slab:
    # captured (the roomy engine) and eager (an engine of the same
    # weights with cuda_graphs=False), greedy and with 2 of the 8 slots
    # sampled (as over HTTP); their tokens must be equal bitwise
    eager = PagedGenerativeEngine(config, params, max_slots=8, page_size=16,
                                  n_pages=1024, device=dev,
                                  cuda_graphs=False)
    rng = np.random.default_rng(2)
    batch_1024 = [rng.integers(1, config.vocab, 1024) for _ in range(8)]
    n_steps = 32
    runs = {}
    for label, eng in (("captured", roomy), ("eager", eager)):
        t0 = time.monotonic()
        slots, _ = eng.admit(batch_1024)
        prefill_ms = (time.monotonic() - t0) * 1e3
        eng.decode_many()
        outs, ms = timed_rounds(eng.decode_many, n_steps)
        prof = profile_device(torch, eng.decode_many, 8)
        for s_ in slots:
            eng.release(s_)
        slots, _ = eng.admit(batch_1024, [SAMPLED.get(i) for i in range(8)])
        eng.decode_many()
        souts, sms = timed_rounds(eng.decode_many, n_steps)
        prof_sampled = profile_device(torch, eng.decode_many, 8)
        for s_ in slots:
            eng.release(s_)
        runs[label] = dict(
            prefill_8x1024_ms=prefill_ms, decode_ms=pcts(ms),
            sampled_ms=pcts(sms), profile=prof, profile_sampled=prof_sampled,
            tokens=[o[0][slots, 0].tolist() for o in outs],
            sampled_tokens=[o[0][slots, 0].tolist() for o in souts])
    del eager
    for key in ("tokens", "sampled_tokens"):
        if runs["captured"][key] != runs["eager"][key]:
            raise AssertionError("captured paged %s != eager" % key)
    for label, r in runs.items():
        log("  engine %s: prefill 8 x 1024 tokens %.2f ms; decode round over "
            "8 slots p50 %.3f p99 %.3f mean %.3f ms = %.1f tokens/s (slab "
            "engine captured: %.3f ms), with 2 sampled slots p50 %.3f p99 "
            "%.3f ms [%s]" % (label, r["prefill_8x1024_ms"],
                              r["decode_ms"]["p50"], r["decode_ms"]["p99"],
                              r["decode_ms"]["mean"],
                              8 * 1e3 / r["decode_ms"]["mean"],
                              slab["engine"]["decode_step_ms"],
                              r["sampled_ms"]["p50"], r["sampled_ms"]["p99"],
                              card))
        for what, pr in (("paged decode round", r["profile"]),
                         ("round with 2 sampled slots",
                          r["profile_sampled"])):
            if pr is not None:
                log("  profile %s, %s: wall %.3f ms, device %.3f ms (busy "
                    "%.0f%%), flash decode (K5) %.3f ms; by class: %s" % (
                        what, label, pr["wall_ms"], pr["device_ms"],
                        100 * pr["busy_share"], pr["flash_decode_ms"],
                        "; ".join("%s %.3f ms" % kv for kv in sorted(
                            pr["by_class"].items(), key=lambda kv: -kv[1]))))
    log("  captured paged tokens == eager over %d greedy and %d sampled "
        "rounds: True" % (n_steps, n_steps))
    cap = runs["captured"]
    result["engine"] = dict(prefill_8x1024_ms=cap["prefill_8x1024_ms"],
                            decode_round_ms=cap["decode_ms"]["mean"],
                            decode_tokens_per_s=8 * 1e3 /
                            cap["decode_ms"]["mean"],
                            sampled_round_ms=cap["sampled_ms"]["mean"],
                            profile_decode=cap["profile"],
                            profile_sampled=cap["profile_sampled"],
                            captured=runs["captured"], eager=runs["eager"])
    del roomy
    return result, launches_main


# ---------------------------------------------------------------------------
# phase 8: paged parity on the card
# ---------------------------------------------------------------------------

def _spec_pair(config_cls, init_params, width, t_layers, d_layers,
               compute):
    """bench_serve.py's speculative construction: the draft's blocks,
    embeddings and final norm are the target's first ones; the target's
    later blocks have zero ``proj`` and ``mlp_out`` (residual
    identities), so target(x) == draft(x) at the target's depth."""
    dcfg = config_cls(compute=compute, **dict(width, layers=d_layers))
    tcfg = config_cls(compute=compute, **dict(width, layers=t_layers))
    dparams = init_params(dcfg, seed=11)
    tparams = init_params(tcfg, seed=12)
    for key in ("embed", "pos", "ln_f"):
        tparams[key] = dparams[key]
    tparams["blocks"][:d_layers] = dparams["blocks"]
    for blk in tparams["blocks"][d_layers:]:
        blk["proj"] = np.zeros_like(blk["proj"])
        blk["mlp_out"] = np.zeros_like(blk["mlp_out"])
    return tcfg, tparams, dcfg, dparams


def paged_parity_phase(torch, fa, dev, card):
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from veles_tpu_torch.serve import GenerativeEngine, PagedGenerativeEngine

    log("phase 8: paged parity on the card")
    small = dict(FULL, layers=2)
    params = init_params(TransformerConfig(**small), seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, small["vocab"], n).astype(np.int32)
               for n in (10, 100, 700)]
    gens = {}
    for impl in ("cuda", "plain"):
        cfg = TransformerConfig(compute="float32", attention_impl=impl,
                                **small)
        engine = PagedGenerativeEngine(cfg, params, max_slots=4, device=dev)
        engine.warm()    # captures the rounds, whose warm-ups launch K5
        fa.reset_launches()
        gens[impl] = [g.tolist() for g in engine.generate(prompts, 32)]
        if impl == "cuda" and fa.LAUNCHES["flash_decode_paged"] != 2 * 31:
            raise AssertionError("K5 launches %s" % fa.LAUNCHES)
        del engine
    cfg = TransformerConfig(compute="float32", **small)
    slab = [g.tolist() for g in GenerativeEngine(
        cfg, params, max_slots=4, device=dev).generate(prompts, 32)]
    log("  f32 2-layer greedy, 3 prompts x 32 tokens: K5 == plain %s, "
        "K5 == slab (K4) %s" % (gens["cuda"] == gens["plain"],
                                gens["cuda"] == slab))
    if not gens["cuda"] == gens["plain"] == slab:
        raise AssertionError("paged greedy tokens differ: %r / %r / %r"
                             % (gens["cuda"], gens["plain"], slab))
    # a pool that preempts (max_len 512: 32 pages hold one sequence; the
    # prompts take 30 and their 32 tokens 6 more)
    pre = [rng.integers(1, small["vocab"], n).astype(np.int32)
           for n in (60, 150, 250)]
    outs = {}
    for n_pages in (32, None):
        engine = PagedGenerativeEngine(cfg, params, max_slots=4, max_len=512,
                                       n_pages=n_pages, device=dev)
        outs[n_pages] = ([g.tolist() for g in engine.generate(pre, 32)],
                         engine.preempted_total)
    log("  f32 32-page pool: %d preemptions, tokens == unpreempted: %s"
        % (outs[32][1], outs[32][0] == outs[None][0]))
    if not outs[32][1] or outs[32][0] != outs[None][0]:
        raise AssertionError("preempted run differs or did not preempt")
    result = dict(greedy_equal_plain=True, greedy_equal_slab=True,
                  preempted=outs[32][1], preempted_equal=True)

    # speculative decoding: f32 exact, then bf16 at full depth
    for compute, t_layers, n_new, slots in (("float32", 4, 32, 4),
                                            ("bfloat16", 12, 64, 8)):
        tcfg, tparams, dcfg, dparams = _spec_pair(
            TransformerConfig, init_params, FULL, t_layers, 2, compute)
        sprompts = [rng.integers(1, FULL["vocab"], n).astype(np.int32)
                    for n in (16, 64, 100, 200, 300, 500, 700, 1000)[:slots]]
        runs = {}
        # bf16 at full depth: each mode captured, then eager
        ways = (True, False) if compute == "bfloat16" else (True,)
        for mode in ("greedy", "spec"):
            kw = dict(draft_params=dparams, draft_config=dcfg,
                      draft_tokens=4) if mode == "spec" else {}
            for graphs in ways:
                engine = PagedGenerativeEngine(tcfg, tparams, max_slots=slots,
                                               device=dev, cuda_graphs=graphs,
                                               **kw)
                sampling = [{"draft": mode == "spec"}] * slots
                engine.generate(sprompts, 2, sampling=sampling)   # warm
                torch.cuda.synchronize()
                t0 = time.monotonic()
                toks = [g.tolist() for g in engine.generate(
                    sprompts, n_new, sampling=sampling)]
                wall = time.monotonic() - t0
                label = mode if graphs else mode + " eager"
                runs[label] = (toks, slots * n_new / wall,
                               engine.decode_stats().get("spec_accept_rate"))
                if compute == "bfloat16":
                    # one round of each, profiled: where its time goes
                    engine.admit(sprompts, sampling)
                    prof = profile_device(torch, engine.decode_many, 2)
                    if prof is not None:
                        log("  profile %s round (bf16, %d layers): wall "
                            "%.3f ms, device %.3f ms (busy %.0f%%); by "
                            "class: %s" % (
                                label, t_layers, prof["wall_ms"],
                                prof["device_ms"], 100 * prof["busy_share"],
                                "; ".join("%s %.3f ms" % kv for kv in sorted(
                                    prof["by_class"].items(),
                                    key=lambda kv: -kv[1]))))
                    result["profile_%s_round" % label.replace(" ", "_")] = \
                        prof
                del engine
        if compute == "bfloat16":
            for mode in ("greedy", "spec"):
                if runs[mode][0] != runs[mode + " eager"][0]:
                    raise AssertionError("bf16 %s: captured tokens != eager"
                                         % mode)
            log("  bf16 eager: greedy %.1f tokens/s, speculative %.1f "
                "tokens/s (%.2fx); captured tokens == eager in both modes"
                % (runs["greedy eager"][1], runs["spec eager"][1],
                   runs["spec eager"][1] / runs["greedy eager"][1]))
            result["spec_eager_bfloat16"] = dict(
                greedy_tokens_per_s=runs["greedy eager"][1],
                spec_tokens_per_s=runs["spec eager"][1])
        (gt, g_tps, _), (st, s_tps, acc) = runs["greedy"], runs["spec"]
        agree = _agreement(st, gt)
        log("  speculative %s, %d-layer target, 2-layer draft, K = 4, %d "
            "slots x %d tokens: %.1f tokens/s vs greedy %.1f (%.2fx), "
            "acceptance %.4f, tokens equal to greedy %d of %d [%s]" % (
                compute, t_layers, slots, n_new, s_tps, g_tps, s_tps / g_tps,
                acc, agree, slots * n_new, card))
        if compute == "float32" and (st != gt or acc != 1.0):
            raise AssertionError("f32 speculative != greedy or acceptance "
                                 "%r != 1.0" % acc)
        if compute == "bfloat16" and acc < SPEC_ACCEPT_MIN:
            raise AssertionError("bf16 acceptance %.4f < %.2f"
                                 % (acc, SPEC_ACCEPT_MIN))
        result["spec_%s" % compute] = dict(
            target_layers=t_layers, draft_layers=2, k=4, slots=slots,
            tokens=n_new, spec_tokens_per_s=s_tps,
            greedy_tokens_per_s=g_tps, acceptance=acc,
            tokens_equal_greedy=agree)
    return result


# ---------------------------------------------------------------------------
# phase 9: classifier training at full width
# ---------------------------------------------------------------------------

def _conv1_both_ways(torch, trainer, x):
    """conv1 (11 x 11, stride 4, on RGB) through the space-to-depth
    rewrite the trainer takes and through the plain strided conv, at
    the phase's batch in bf16: forward alone, then forward + backward
    to the weights."""
    from veles_tpu_torch.nn.conv import conv_raw, conv_s2d_raw
    _, _, strides, padding = trainer.specs[0]
    w = trainer.params[0]["w"]
    b = trainer.params[0]["b"]
    xb = x.to(torch.bfloat16)
    out = {}
    for name, fn in (("s2d", conv_s2d_raw), ("plain", conv_raw)):
        def fwd():
            with torch.no_grad():
                return fn(xb, w, b, strides, padding, torch.bfloat16,
                          torch.bfloat16)

        def fwd_bwd():
            y = fn(xb, w, b, strides, padding, torch.bfloat16,
                   torch.bfloat16)
            return torch.autograd.grad(y.float().sum(), w)

        out[name] = dict(fwd_ms=time_ms(fwd, 5), fwd_bwd_ms=time_ms(fwd_bwd,
                                                                     5))
    faster = min(out, key=lambda kk: out[kk]["fwd_bwd_ms"])
    log("  conv1 [%d, 224, 224, 3] bf16: space-to-depth fwd %.3f ms, "
        "fwd+bwd %.3f ms; strided conv fwd %.3f ms, fwd+bwd %.3f ms; "
        "faster: %s" % (x.shape[0], out["s2d"]["fwd_ms"],
                        out["s2d"]["fwd_bwd_ms"], out["plain"]["fwd_ms"],
                        out["plain"]["fwd_bwd_ms"], faster))
    out["faster_fwd_bwd"] = faster
    return out


def classifier_phase(torch, counters, dev, card):
    from veles_tpu_torch.models.flagship import alexnet_fused
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer

    b = CLASSIFIER_BATCH
    log("phase 9: classifier training, AlexNet (1000 classes, 224 x 224 "
        "x 3, seed 0), batch %d, bf16, %s" % (b, CLASSIFIER_HYPER))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    specs, params, fwd_flops = alexnet_fused()
    n_params = sum(p["w"].size + p["b"].size for p in params if p)
    trainer = FusedClassifierTrainer(specs, params, device=dev,
                                     **CLASSIFIER_HYPER)
    del params
    data = np.random.default_rng(1)              # bench.py:85-88
    x = torch.from_numpy(data.random((b, 224, 224, 3),
                                     dtype=np.float32)).to(dev)
    labels = torch.from_numpy(data.integers(0, 1000, b)).to(dev)
    setup_s = time.monotonic() - t0

    counters.reset()
    losses = [trainer.step(x, labels)["loss"] for _ in range(3)]  # warm-up
    torch.cuda.synchronize()
    before = counters.read()
    losses.append(trainer.step(x, labels)["loss"])
    torch.cuda.synchronize()
    one_step = counters.delta(before)
    n_timed = 10
    t0 = time.monotonic()
    for _ in range(n_timed):
        losses.append(trainer.step(x, labels)["loss"])
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / n_timed
    k_many = 4
    t0 = time.monotonic()
    many = trainer.step_many(x[None].expand(k_many, *x.shape),
                             labels[None].expand(k_many, b))
    torch.cuda.synchronize()
    many_ms = (time.monotonic() - t0) * 1e3 / k_many
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated()
    if tuple(many["loss"].shape) != (k_many,):
        raise AssertionError("step_many returned losses of shape %s"
                             % (tuple(many["loss"].shape),))
    losses = torch.stack(losses + list(many["loss"])).tolist()
    expect = {"lrn_fwd": 2, "lrn_bwd": 2, "uniform_fill": 2}
    log("  launches around one step: %s (need exactly %s)"
        % (one_step, expect))
    if {kk: v for kk, v in one_step.items() if v} != expect:
        raise AssertionError("classifier step launches %s != %s"
                             % (one_step, expect))
    before = counters.read()
    logits = trainer.predict(x)
    torch.cuda.synchronize()
    predict_launches = counters.delta(before)
    log("  launches around one predict: %s (need exactly lrn_fwd 2)"
        % (predict_launches,))
    if {kk: v for kk, v in predict_launches.items() if v} != {"lrn_fwd": 2}:
        raise AssertionError("predict launches %s" % (predict_launches,))
    if tuple(logits.shape) != (b, 1000) or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("predict gave %s %s" % (tuple(logits.shape),
                                                     logits.dtype))
    del logits

    images_per_s = b * 1e3 / step_ms
    step_flops = 3 * fwd_flops * b               # bench.py's formula
    log("  %d params; set-up %.1f s; ms per step %.3f (window of %d), "
        "step_many(%d) %.3f ms per step; %.1f images/s; model %.1f TFLOP/s "
        "(%.3f TFLOP per step, bf16 peak bound %.3f ms); peak memory %.2f "
        "GB [%s]" % (n_params, setup_s, step_ms, n_timed, k_many, many_ms,
                     images_per_s, step_flops / step_ms / 1e9,
                     step_flops / 1e12, step_flops / PEAK_FLOPS["bfloat16"]
                     * 1e3, peak / 1e9, card))
    log("  losses: %s" % ", ".join("%.4f" % v for v in losses))
    if not all(np.isfinite(losses)) or trainer.nonfinite_count:
        raise AssertionError("non-finite classifier loss: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall on the fixed batch: %s"
                             % losses)

    prof = profile_device(
        torch, lambda: float(trainer.step(x, labels)["loss"]), 2)
    if prof is None:
        log("  profile classifier step: no device time recorded")
    else:
        log("  profile classifier step: wall %.3f ms, device %.3f ms (busy "
            "%.0f%%); top kernels: %s" % (
                prof["wall_ms"], prof["device_ms"], 100 * prof["busy_share"],
                "; ".join("%s %.3f ms x%g" % (r["kernel"][:40], r["ms"],
                                              r["launches"])
                          for r in prof["top"][:6])))
        log("  classifier step device time by class: %s" % "; ".join(
            "%s %.3f ms" % kv for kv in sorted(
                prof["by_class"].items(), key=lambda kv: -kv[1])))
    conv1 = _conv1_both_ways(torch, trainer, x)
    del trainer, x, labels, many
    return dict(batch=b, n_params=n_params, hyper=CLASSIFIER_HYPER,
                setup_s=setup_s, step_ms=step_ms, timed_steps=n_timed,
                step_many_k=k_many, step_many_ms_per_step=many_ms,
                images_per_s=images_per_s, fwd_flops_per_image=fwd_flops,
                model_tflops=step_flops / step_ms / 1e9,
                peak_mem_bytes=peak, losses=losses,
                launches_one_step=one_step,
                launches_predict=predict_launches, profile=prof,
                conv1=conv1), launches


# ---------------------------------------------------------------------------
# phase 10: classifier parity on the card
# ---------------------------------------------------------------------------

def classifier_parity_phase(torch, dev):
    from veles_tpu_torch.models.flagship import alexnet_fused
    from veles_tpu_torch.ops.rng import fold_in, uniform_fill
    from veles_tpu_torch.parallel.fused import (FusedClassifierTrainer,
                                                _leaves, _loss_fn)

    n_steps = 3
    log("phase 10: classifier parity, AlexNet (10 classes, 64 x 64) f32, "
        "batch 8, dropout 0.5, kernels vs plain, %d steps" % n_steps)
    specs, params, _ = alexnet_fused(n_classes=10, image_size=64)
    data = np.random.default_rng(7)
    batches = [(torch.from_numpy(data.random((8, 64, 64, 3),
                                             dtype=np.float32)).to(dev),
                torch.from_numpy(data.integers(0, 10, 8)).to(dev))
               for _ in range(n_steps)]
    # the first step's dropout masks, both ways
    for layer in (11, 13):
        seed = fold_in(fold_in(0, 1), layer)
        if not torch.equal(
                uniform_fill(seed, (8, 4096), device=dev, impl="cuda"),
                uniform_fill(seed, (8, 4096), device=dev, impl="plain")):
            raise AssertionError("dropout mask of layer %d differs" % layer)
    runs = {}
    for impl in ("cuda", "plain"):
        t = FusedClassifierTrainer(specs, params, compute_dtype="float32",
                                   kernel_impl=impl, device=dev,
                                   **CLASSIFIER_HYPER)
        x0, y0 = batches[0]
        loss, _ = _loss_fn(t.specs, True, t.params, x0, y0,
                           fold_in(t.dropout_seed, 1), t.compute_dtype, impl)
        grads = [g.detach() for g in torch.autograd.grad(
            loss, _leaves(t.params))]
        losses = [float(t.step(x, y)["loss"]) for x, y in batches]
        runs[impl] = (losses, grads, _leaves(t.params))
        del t
    (lk, gk, pk), (lp, gp, pp) = runs["cuda"], runs["plain"]

    def share(a, c):
        return float((a - c).abs().max() / c.abs().max().clamp_min(1e-30))

    grad_err = max(share(a, c) for a, c in zip(gk, gp))
    param_err = max(share(a.detach(), c.detach()) for a, c in zip(pk, pp))
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(lk, lp))
    log("  losses kernels %s, plain %s" % (lk, lp))
    check("classifier grads step 1, kernels vs plain (share of each "
          "leaf's scale)", grad_err, TOL_CLASSIFIER["float32"])
    check("classifier losses, kernels vs plain (relative)", loss_err,
          TOL_CLASSIFIER["float32"])
    check("classifier params after %d steps (share of each leaf's scale)"
          % n_steps, param_err, TOL_CLASSIFIER["float32"])

    # the full-width bf16 forward, kernels vs plain, on 64 images
    specs, params, _ = alexnet_fused()
    x = torch.from_numpy(np.random.default_rng(8).random(
        (64, 224, 224, 3), dtype=np.float32)).to(dev)
    logits = {}
    for impl in ("cuda", "plain"):
        t = FusedClassifierTrainer(specs, params, kernel_impl=impl,
                                   device=dev)
        logits[impl] = t.predict(x)
        del t
    err = float((logits["cuda"] - logits["plain"]).abs().max())
    scale = float(logits["plain"].abs().max())
    log("  bf16 full-width forward logits [64, 1000]: max |kernel - plain| "
        "%.4e (logit scale %.4f)" % (err, scale))
    check("classifier bf16 logits, kernels vs plain (share of scale)",
          err / scale, TOL_CLASSIFIER["bfloat16"])
    return dict(losses_kernels=lk, losses_plain=lp, loss_rel_err=loss_err,
                grad_rel_err=grad_err, param_rel_err=param_err,
                steps=n_steps, bf16_logit_err=err, bf16_logit_scale=scale)


# ---------------------------------------------------------------------------
# phase 11: the classifier served through POST /apply
# ---------------------------------------------------------------------------

def apply_phase(torch, counters, dev, card):
    from veles_tpu_torch.models.flagship import alexnet_fused
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    from veles_tpu_torch.serve import (InferenceEngine, ModelRegistry,
                                       ServeServer)

    log("phase 11: serving AlexNet (alexnet_fused(), seed 0, bf16) through "
        "InferenceEngine -> MicroBatcher -> registry -> POST /apply, "
        "buckets %s" % (APPLY_BUCKETS,))
    specs, params, _ = alexnet_fused()
    engine = InferenceEngine.from_specs(specs, params, device=dev,
                                        name="alexnet")
    eager = InferenceEngine.from_specs(specs, params, device=dev,
                                       cuda_graphs=False)
    t0 = time.monotonic()
    added = engine.warmup((224, 224, 3), APPLY_BUCKETS[-1])
    warm_s = time.monotonic() - t0
    eager.warmup((224, 224, 3), APPLY_BUCKETS[-1])
    log("  warmup captured %d bucket graphs in %.1f s; compile_count %d, "
        "buckets %s" % (added, warm_s, engine.compile_count, engine.buckets))
    if added != len(APPLY_BUCKETS) or engine.buckets != APPLY_BUCKETS or \
            engine.compile_count != len(APPLY_BUCKETS):
        raise AssertionError("compile_count %d, buckets %s"
                             % (engine.compile_count, engine.buckets))
    # the outputs against the trainer's forward on the same rows
    rng = np.random.default_rng(12)
    x = rng.random((APPLY_BUCKETS[-1], 224, 224, 3), dtype=np.float32)
    probs = engine.apply(x)
    trainer = FusedClassifierTrainer(specs, params, device=dev)
    ref = torch.softmax(trainer.predict(x), dim=-1).cpu().numpy()
    del trainer, params
    check("apply probabilities vs softmax(FusedClassifierTrainer.predict), "
          "bf16, %d rows (absolute)" % len(x),
          float(np.abs(probs - ref).max()), TOL_APPLY)
    # per bucket: captured against eager (bitwise), timed, and K6 twice
    # a replay
    per_bucket = {}
    for b in APPLY_BUCKETS:
        rows = x[:b]
        counters.reset()
        got = engine.apply(rows)
        one = {k: v for k, v in counters.read().items() if v}
        if one != {"lrn_fwd": 2}:
            raise AssertionError("bucket %d: launches %s per replay"
                                 % (b, one))
        if not np.array_equal(got, eager.apply(rows)):
            raise AssertionError("bucket %d: captured != eager" % b)
        _, ms = timed_rounds(lambda: engine.apply(rows), 10)
        _, ems = timed_rounds(lambda: eager.apply(rows), 10)
        per_bucket[b] = dict(captured_ms=pcts(ms), eager_ms=pcts(ems))
    log("  apply ms p50, captured / eager, by bucket: %s [%s]" % (
        ", ".join("%d: %.3f / %.3f" % (b, r["captured_ms"]["p50"],
                                        r["eager_ms"]["p50"])
                  for b, r in per_bucket.items()), card))
    log("  launches per replay: lrn_fwd 2; captured == eager bitwise in "
        "every bucket")
    del eager

    registry = ModelRegistry()
    model = registry.add("alexnet", engine, max_batch=APPLY_BUCKETS[-1],
                         max_delay_ms=5)
    server = ServeServer(registry, port=0, timeout=600)
    sizes = (1, 2, 3)
    requests = [rng.random((n, 224, 224, 3), dtype=np.float32)
                for n in sizes]
    answers = [None] * len(sizes)
    try:
        url = "http://%s:%d/apply" % server.endpoint

        def client(i):
            try:
                with _post(url, {"input": requests[i].tolist()}) as resp:
                    answers[i] = np.asarray(json.loads(resp.read())[
                        "output"], np.float32)
            except BaseException as e:  # noqa: BLE001 — reported below
                answers[i] = e

        snap0 = model.metrics.snapshot()
        counters.reset()
        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.monotonic() - t0
        launches = counters.read()
        snap1 = model.metrics.snapshot()
        prom = _get("http://%s:%d/metrics?format=prometheus"
                    % server.endpoint)
    finally:
        server.stop()
    dispatches = snap1["dispatches_total"] - snap0["dispatches_total"]
    for i, a in enumerate(answers):
        if isinstance(a, BaseException) or a.shape != (sizes[i], 1000):
            raise AssertionError("request %d answered %r" % (i, a))
        check("POST /apply request %d vs apply on its rows (absolute)" % i,
              float(np.abs(a - engine.apply(requests[i])).max()), TOL_APPLY)
    if launches["lrn_fwd"] != 2 * dispatches or not dispatches or \
            'veles_serve_requests_total{model="alexnet"}' not in prom:
        raise AssertionError("%d dispatches, launches %s"
                             % (dispatches, launches))
    log("  %d POST /apply requests (%s rows) answered in %.3f s over %d "
        "dispatches; launches %s; compile_count still %d"
        % (len(sizes), list(sizes), wall, dispatches,
           {k: v for k, v in launches.items() if v}, engine.compile_count))
    if engine.compile_count != len(APPLY_BUCKETS):
        raise AssertionError("compile_count grew to %d"
                             % engine.compile_count)
    return dict(buckets=APPLY_BUCKETS, warm_s=warm_s,
                compile_count=engine.compile_count,
                predict_abs_err=float(np.abs(probs - ref).max()),
                per_bucket=per_bucket, http_wall_s=wall,
                http_dispatches=dispatches), launches


# ---------------------------------------------------------------------------
# phase 12: the unit graph (units, workflow, devices, arrays, prng over K8)
# ---------------------------------------------------------------------------

#: the unit-graph phase: the fill's shape, the Repeater's passes a run
GRAPH_FILL = (8192, 4096)
GRAPH_PASSES = 4
GRAPH_SEED = 2024
#: the CPU run of the same graph (the order and counters it is held to)
#: fills a smaller array: the plain Philox on the host is slow
GRAPH_FILL_CPU = (256, 4096)


def build_unit_graph(device, shape, log_runs):
    """start -> repeater -> fill (an AcceleratedUnit: a [shape] f32
    Array through ``prng.get("smoke").uniform``, K8 on the card) ->
    reduce (an AcceleratedUnit: the Array's sum on its device) ->
    decide (a host unit whose Bool closes the loop after
    ``GRAPH_PASSES`` passes) -> repeater | end. Returns (workflow,
    {name: unit}); every run appends (unit, its run count) to
    ``log_runs``."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.accelerated_units import (AcceleratedUnit,
                                                   AcceleratedWorkflow)
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.mutable import Bool
    from veles_tpu_torch.plumbing import Repeater
    from veles_tpu_torch.units import Unit

    class Fill(AcceleratedUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.output = Array()       # the reduce unit links to it

        def initialize(self, device=None, **kwargs):
            retry = super().initialize(device=device, **kwargs)
            if retry:
                return retry
            self.init_array("output", shape=shape)
            self.passes = 0
            return None

        def run(self):
            self.passes += 1
            self.output.devmem = prng.get("smoke").uniform(
                shape, device=self.device.torch_device)
            log_runs.append((self.name, self.passes))

    class Reduce(AcceleratedUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.demand("input")

        def initialize(self, device=None, **kwargs):
            retry = super().initialize(device=device, **kwargs)
            if retry:
                return retry
            self.init_array("total", shape=(1,))
            self.passes = 0
            return None

        def run(self):
            self.passes += 1
            self.total.devmem = self.input.devmem.sum(
                dtype=torch.float64).reshape(1)
            log_runs.append((self.name, self.passes))

    done = Bool(False, name="done")

    class Decide(Unit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.passes = 0

        def run(self):
            self.passes += 1
            done.__ilshift__(self.passes % GRAPH_PASSES == 0)
            log_runs.append((self.name, self.passes))

    class Reset(Unit):
        def run(self):
            done.__ilshift__(False)

    wf = AcceleratedWorkflow(None, name="unit-graph")
    reset = Reset(wf, name="reset")
    rpt = Repeater(wf)
    fill = Fill(wf, name="fill")
    red = Reduce(wf, name="reduce")
    dec = Decide(wf, name="decide")
    reset.link_from(wf.start_point)
    rpt.link_from(reset)
    fill.link_from(rpt)
    red.link_from(fill)
    dec.link_from(red)
    rpt.link_from(dec)
    wf.end_point.link_from(dec)
    rpt.gate_block = done
    wf.end_point.gate_block = ~done
    red.link_attrs(fill, ("input", "output"))
    wf.initialize(device=device)
    return wf, dict(fill=fill, reduce=red, decide=dec)


def unit_graph_phase(torch, counters, dev, card):
    import zlib

    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import CudaDevice, Device
    from veles_tpu_torch.ops import rng as rng_ops

    log("phase 12: a unit-graph workflow on Device(): start -> repeater "
        "-> fill %s f32 through prng.get('smoke').uniform (K8) -> reduce "
        "on the card -> decide (%d passes) -> end" % (GRAPH_FILL,
                                                      GRAPH_PASSES))
    prng.reset()
    prng.get("smoke").seed(GRAPH_SEED)
    device = Device()
    if not isinstance(device, CudaDevice):
        raise AssertionError("Device() is %r, not the card" % (device,))
    log_runs = []
    wf, units = build_unit_graph(device, GRAPH_FILL, log_runs)
    counters.reset()
    t0 = time.monotonic()
    wf.run()
    wall = time.monotonic() - t0
    launches = counters.read()
    fill, red = units["fill"], units["reduce"]
    # the last pass's fill against the plain Philox under the stream's
    # key schedule, on the same card
    key = rng_ops.fold_in(GRAPH_SEED, zlib.crc32(b"smoke"))
    plain = rng_ops.uniform_fill(rng_ops.fold_in(key, GRAPH_PASSES),
                                 GRAPH_FILL, device=dev, impl="plain")
    got = fill.output.devmem
    if not torch.equal(got, plain):
        raise AssertionError("the fill differs from the plain Philox")
    host = fill.output.map_read()
    if not np.array_equal(host, got.cpu().numpy()):
        raise AssertionError("map_read after the device write differs "
                             "from the device's values")
    total = float(red.total.map_read()[0])
    if not np.isclose(total, float(plain.double().sum()), rtol=1e-9) or \
            abs(total / plain.numel() - 0.5) > 1e-3:
        raise AssertionError("reduce total %r" % total)
    if launches["uniform_fill"] != GRAPH_PASSES or \
            any(v for k, v in launches.items() if k != "uniform_fill"):
        raise AssertionError("launches %s for %d passes"
                             % (launches, GRAPH_PASSES))
    counts = {name: u.run_count_ for name, u in units.items()}
    # the same graph on the CPU: the same run order and counters
    cpu_runs = []
    prng.reset()
    prng.get("smoke").seed(GRAPH_SEED)
    cpu_wf, cpu_units = build_unit_graph(Device(backend="cpu"),
                                         GRAPH_FILL_CPU, cpu_runs)
    cpu_wf.run()
    cpu_counts = {name: u.run_count_ for name, u in cpu_units.items()}
    cpu_wf.thread_pool.shutdown()
    if cpu_runs != log_runs or cpu_counts != counts:
        raise AssertionError("run order %s / counters %s on the card, %s / "
                             "%s on the CPU" % (log_runs, counts, cpu_runs,
                                                cpu_counts))
    stats = {name: dict(calls=c, avg_ms=avg * 1e3)
             for name, _, c, avg in wf.get_unit_run_time_stats()}
    log("  %d passes in %.3f s; launches %s (uniform_fill 1 a pass); fill "
        "== plain Philox bitwise; map_read == device; sum %.1f (mean "
        "%.6f); run order and counters == the CPU run's (%d runs) [%s]"
        % (GRAPH_PASSES, wall, {k: v for k, v in launches.items() if v},
           total, total / plain.numel(), len(log_runs), card))
    log("  unit run times: %s" % ", ".join(
        "%s %d x %.3f ms" % (n, r["calls"], r["avg_ms"])
        for n, r in stats.items()))
    del plain, got
    return dict(fill_shape=list(GRAPH_FILL), passes=GRAPH_PASSES,
                wall_s=wall, run_log=log_runs, counters=counts,
                unit_stats=stats, total=total,
                cpu_fill_shape=list(GRAPH_FILL_CPU)), launches, \
        (wf, units, log_runs)


# ---------------------------------------------------------------------------
# phase 13: one card shared by four tenants
# ---------------------------------------------------------------------------

#: the co-tenancy phase: the train tenant's ``step_many(K)`` windows,
#: COTENANT_WINDOWS in window A (the first captures the step and is not
#: timed) and COTENANT_PROFILED_WINDOWS in the profiled window B
COTENANT_K = 4
COTENANT_WINDOWS = 16
COTENANT_PROFILED_WINDOWS = 3
#: /apply clients: each a thread that sends its own image row once every
#: APPLY_PERIOD_S (or as soon as the previous answer came, when that was
#: later), each request with ``deadline_ms``, as raw f32 bytes (no JSON
#: for the server to parse under the tenants' interpreter lock): a
#: steady 32 requests/s that does not saturate the apply tenant
APPLY_CLIENTS = 16
APPLY_PERIOD_S = 0.5
APPLY_DEADLINE_MS = 60000
#: what the clients send in the window with the train and graph tenants
#: idle: requests per /apply client, staggered /generate runs
SOLO_APPLY_REQUESTS = 8
SOLO_GENERATE_RUNS = 3
#: a p99 is read over this many samples at least; under it, it would be
#: the maximum, and none is printed
TAIL_MIN_SAMPLES = 100


def latency_stats(ms):
    """The sample's size, p50, p99 (None under TAIL_MIN_SAMPLES) and
    maximum."""
    ms = np.asarray(ms, np.float64)
    p50, p99 = np.percentile(ms, (50, 99))
    return dict(n=int(ms.size), p50=float(p50), max=float(ms.max()),
                p99=float(p99) if ms.size >= TAIL_MIN_SAMPLES else None)


def fmt_stats(s):
    tail = "p99 %.3f" % s["p99"] if s["p99"] is not None else \
        "p99 not read"
    return "p50 %.3f, %s, max %.3f ms (n=%d)" % (s["p50"], tail, s["max"],
                                                 s["n"])


def _train_windows(trainer, windows):
    """``step_many(K)`` over each [K, B, T+1] batch; each window's
    losses and its wall time (a window ends when its quantum does: on
    the device, with a tenant)."""
    losses, walls = [], []
    for batch in windows:
        t0 = time.monotonic()
        out = trainer.step_many(batch)
        losses.append(out["loss"])
        walls.append((time.monotonic() - t0) * 1e3)
    return [float(x) for w in losses for x in w], walls


def _image_rows(n, shape):
    """The /apply clients' rows, one image each: uniform [0, 1) f32, as
    phase 11's."""
    rng = np.random.default_rng(12)
    return [rng.random(tuple(shape), dtype=np.float32) for _ in range(n)]


def _generate_client(url, prompts, n_tok, min_runs, go, stop, conn):
    """Phase 13's serve client, in a process of its own (a deployment's
    clients are other processes: their JSON work must not take the
    tenants' interpreter lock): staggered runs of the prompts, one after
    another, until ``stop`` is set (``min_runs`` at least); sends back
    each run's tokens per prompt (or the error's repr)."""
    conn.send("ready")
    go.wait()
    runs = []
    while len(runs) < min_runs or not stop.is_set():
        out = _staggered_generate(url, prompts, n_tok)
        runs.append([a if isinstance(a, list) else repr(a) for a in out])
    conn.send(runs)
    conn.close()


def _apply_client(url, shape, n_clients, min_requests, go, stop, conn):
    """Phase 13's /apply clients, threads of a process of their own:
    client j sends image row j every APPLY_PERIOD_S (their phases spread
    over the period) with ``deadline_ms``, until ``stop`` is set
    (``min_requests`` at least); sends back ("ok", [(j, output row)], [latency ms]) or ("error",
    [repr], [latency ms])."""
    bodies = [r.tobytes() for r in _image_rows(n_clients, shape)]
    headers = {"Content-Type": "application/octet-stream",
               "X-Shape": ",".join(str(d) for d in (1,) + tuple(shape)),
               "X-Deadline-Ms": str(APPLY_DEADLINE_MS)}
    conn.send("ready")
    go.wait()
    answers, ms, errors = [], [], []

    def client(j):
        n = 0
        due = time.monotonic() + j * APPLY_PERIOD_S / n_clients
        try:
            while n < min_requests or not stop.is_set():
                time.sleep(max(0.0, due - time.monotonic()))
                t0 = time.monotonic()
                req = urllib.request.Request(url, data=bodies[j],
                                             headers=headers)
                with urllib.request.urlopen(req, timeout=600) as resp:
                    got = json.loads(resp.read())["output"]
                ms.append((time.monotonic() - t0) * 1e3)
                answers.append((j, np.asarray(got, np.float32)[0]))
                n += 1
                due = max(due + APPLY_PERIOD_S, time.monotonic())
        except BaseException as e:  # noqa: BLE001 — reported by the parent
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(j,))
               for j in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    conn.send(("error", errors, ms) if errors else ("ok", answers, ms))
    conn.close()


class _RecordingEngine:
    """The /apply engine as its batcher sees it: each dispatched batch's
    rows (as the clients' row numbers) and output are kept, to be held
    against the engine's answer on the same rows outside the scheduler
    (a batch's composition depends on the timing, its output on the
    batch's bucket)."""

    def __init__(self, engine, rows):
        self.engine = engine
        self.batches = []
        self._row_of = {r.tobytes(): j for j, r in enumerate(rows)}

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def apply(self, x):
        out = self.engine.apply(x)
        self.batches.append(([self._row_of.get(r.tobytes()) for r in x],
                             out))
        return out


def cotenancy_phase(torch, counters, dev, card, serve, train, apply, graph):
    from veles_tpu_torch.models.flagship import alexnet_fused
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerTrainer,
                                                    init_params)
    from veles_tpu_torch.sched import Scheduler, attach_workflow
    from veles_tpu_torch.serve import (GenerativeEngine, InferenceEngine,
                                       ModelRegistry, ServeServer)

    threads_before = set(threading.enumerate())
    config = TransformerConfig(compute="bfloat16", remat="attn", **FULL)
    log("phase 13: one card, four tenants of one Scheduler: train "
        "(TransformerTrainer, phase 5's config, step_many(%d) windows, "
        "weight 1), serve (slab GenerativeEngine, 8 slots, TokenBatcher "
        "-> ServeServer(scheduler=), weight 4), apply (alexnet_fused() "
        "bf16, InferenceEngine -> MicroBatcher, %d clients of raw f32 "
        "rows with deadline_ms, weight 4), graph (phase 12's workflow "
        "through attach_workflow, weight 1)" % (COTENANT_K, APPLY_CLIENTS))
    rng = np.random.default_rng(13)
    n_windows = COTENANT_WINDOWS + COTENANT_PROFILED_WINDOWS
    windows = [torch.from_numpy(rng.integers(
        0, config.vocab, (COTENANT_K, TRAIN_BATCH, config.seq_len + 1))
        ).to(dev) for _ in range(n_windows)]
    mem = {}

    # the train tenant's solo run: the same seed and batches, no tenant
    torch.cuda.reset_peak_memory_stats()
    solo = TransformerTrainer(config, device=dev, seed=0,
                              learning_rate=TRAIN_LR)
    solo_losses, solo_walls = _train_windows(
        solo, windows[:COTENANT_WINDOWS])
    torch.cuda.synchronize()
    mem["train"] = torch.cuda.max_memory_allocated()
    # the same trainer as the only tenant of a scheduler, over window
    # B's batches: what waiting for the device at each window's end
    # costs with no one to share, and the losses window B must give
    lone = Scheduler(name="lone")
    solo.sched_tenant = lone.register("train")
    lone_losses, lone_walls = _train_windows(solo,
                                             windows[COTENANT_WINDOWS:])
    lone.stop()
    del solo
    torch.cuda.empty_cache()

    sched = Scheduler(name="card")
    t_train = sched.register("train", weight=1)
    t_serve = sched.register("serve", weight=4)
    t_apply = sched.register("apply", weight=4)
    t_graph = sched.register("graph", weight=1)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer = TransformerTrainer(config, device=dev, seed=0,
                                 learning_rate=TRAIN_LR)
    trainer.sched_tenant = t_train
    mem["train_cotenant_setup"] = torch.cuda.max_memory_allocated() - base

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    serve_config = TransformerConfig(compute="bfloat16", **FULL)
    lm = GenerativeEngine(serve_config, init_params(serve_config, seed=0),
                          max_slots=8, device=dev)
    registry = ModelRegistry()
    gen_model = registry.add_generative("lm", lm, tenant=t_serve)
    with t_serve.quantum():                   # its captures
        lm.warm()
    mem["serve"] = torch.cuda.max_memory_allocated() - base

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    specs, params, _ = alexnet_fused()
    alex = InferenceEngine.from_specs(specs, params, device=dev,
                                      name="alexnet")
    del params
    rows = _image_rows(APPLY_CLIENTS, APPLY_SHAPE)
    recorder = _RecordingEngine(alex, rows)
    registry.add("alexnet", recorder, max_batch=APPLY_BUCKETS[-1],
                 max_delay_ms=5, tenant=t_apply)
    with t_apply.quantum():                   # its captures
        alex.warmup(APPLY_SHAPE, APPLY_BUCKETS[-1])
    mem["apply"] = torch.cuda.max_memory_allocated() - base

    wf, units, graph_log = graph
    attached = attach_workflow(wf, t_graph)
    if sorted(u.name for u in attached) != ["fill", "reduce"]:
        raise AssertionError("attached %s" % attached)
    mem["graph"] = sum(u.output.nbytes for u in attached
                       if hasattr(u, "output"))
    server = ServeServer(registry, port=0, timeout=600, scheduler=sched)
    try:
        return _cotenancy_windows(
            torch, counters, card, serve, train, apply, config, sched,
            server, gen_model, alex, recorder, rows, trainer, windows,
            solo_losses, solo_walls, lone_losses, lone_walls, mem, wf,
            graph_log, threads_before)
    finally:
        server.stop(drain=False)
        sched.stop()
        wf.thread_pool.shutdown()


def _cotenancy_windows(torch, counters, card, serve, train, apply, config,
                       sched, server, gen_model, alex, recorder, rows,
                       trainer, windows, solo_losses, solo_walls,
                       lone_losses, lone_walls, mem, wf, graph_log,
                       threads_before):
    import torch.profiler as tprof
    from torch.autograd import DeviceType

    from veles_tpu_torch.serve.batcher import GenMetrics

    base_url = "http://%s:%d" % server.endpoint
    tok_per_window = COTENANT_K * TRAIN_BATCH * config.seq_len
    gen_url, apply_url = server.url, base_url + "/apply/alexnet"
    prompts = serving_prompts(config.vocab)
    spawn = multiprocessing.get_context("spawn")

    def clients(stop, min_runs, min_requests):
        """The HTTP clients in processes of their own, ready to go:
        (go event, [(kind, process, parent end of its pipe)])."""
        go = spawn.Event()
        procs = []
        for kind, target, args in (
                ("generate", _generate_client,
                 (gen_url, prompts, 32, min_runs)),
                ("apply", _apply_client,
                 (apply_url, APPLY_SHAPE, APPLY_CLIENTS, min_requests))):
            mine, theirs = spawn.Pipe()
            proc = spawn.Process(target=target,
                                 args=args + (go, stop, theirs))
            proc.start()
            procs.append((kind, proc, mine))
        for kind, proc, mine in procs:
            if not mine.poll(120) or mine.recv() != "ready":
                raise AssertionError("the %s client did not start" % kind)
        return go, procs

    def fresh_decode_metrics():
        gen_model.metrics = gen_model.batcher.metrics = GenMetrics()

    def decode_stats():
        snap = gen_model.metrics.snapshot()
        n = snap["decode_steps_total"]
        return dict(n=n, p50=snap["decode_ms"]["p50"],
                    p99=snap["decode_ms"]["p99"]
                    if n >= TAIL_MIN_SAMPLES else None)

    # serve and apply with the train and graph tenants idle: the decode
    # rounds and /apply latencies the co-tenant ones are read against
    stop = spawn.Event()
    stop.set()
    go, procs = clients(stop, SOLO_GENERATE_RUNS, SOLO_APPLY_REQUESTS)
    fresh_decode_metrics()
    go.set()
    solo = {kind: mine.recv() for kind, _, mine in procs}
    for _, proc, _ in procs:
        proc.join(60)
    if solo["apply"][0] != "ok" or any(
            run != serve["staggered"] for run in solo["generate"]):
        raise AssertionError("solo clients: %r" % (solo,))
    solo_decode = decode_stats()
    solo_apply = latency_stats(solo["apply"][2])
    answers = list(solo["apply"][1])
    fresh_decode_metrics()
    log("  memory at set-up (max allocated, MB): %s [%s]" % (
        ", ".join("%s %.0f" % (k, v / 1e6) for k, v in mem.items()), card))

    def window(batches, profiled):
        out = dict(graph_runs=0, errors=[])
        done = threading.Event()
        stop = spawn.Event()
        go, procs = clients(stop, 1, 1)

        def guard(fn):
            def run():
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 — reported
                    out["errors"].append(repr(e))
            return run

        def train_loop():
            try:
                out["losses"], out["train_walls"] = _train_windows(
                    trainer, batches)
            finally:
                done.set()
                stop.set()

        def graph_loop():
            while out["graph_runs"] < 1 or not done.is_set():
                wf.run()
                out["graph_runs"] += 1

        snap0 = sched.snapshot()["tenants"]
        threads = [threading.Thread(target=guard(f)) for f in
                   (train_loop, graph_loop)]
        prof = None
        if profiled:
            prof = tprof.profile(activities=[tprof.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.monotonic()
        go.set()
        for t in threads:
            t.start()
        results = {}
        for kind, proc, mine in procs:
            results[kind] = mine.recv() if mine.poll(900) else None
            proc.join(60)
        for t in threads:
            t.join(900)
        torch.cuda.synchronize()
        out["wall_ms"] = (time.monotonic() - t0) * 1e3
        out["served"] = results["generate"] or []
        if not out["served"]:
            out["errors"].append("the generate client sent nothing back")
        if results["apply"] is None or results["apply"][0] != "ok":
            out["errors"].append("apply client: %r" % (results["apply"],))
            out["apply"], out["apply_ms"] = [], [0.0]
        else:
            _, out["apply"], out["apply_ms"] = results["apply"]
        if prof is not None:
            prof.__exit__(None, None, None)
            out["busy_ms"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e3
        snap1 = sched.snapshot()["tenants"]
        out["tenants"] = {
            name: dict(quanta=snap1[name]["quanta"] - snap0[name]["quanta"],
                       device_ms=snap1[name]["device_ms"] -
                       snap0[name]["device_ms"],
                       preemptions=snap1[name]["preemptions"] -
                       snap0[name]["preemptions"])
            for name in snap1}
        return out

    # window A: every check, the timings; the launch counters read
    # around it alone
    counters.reset()
    graph_log.clear()
    a = window(windows[:COTENANT_WINDOWS], False)
    launches = counters.read()
    if a["errors"]:
        raise AssertionError("co-tenant loops failed: %s" % a["errors"])
    cot_decode = decode_stats()
    snap_a = sched.snapshot()
    # window B under torch.profiler: the tenants' leased device-ms
    # against the card's busy time over the window
    b = window(windows[COTENANT_WINDOWS:], True)
    if b["errors"]:
        raise AssertionError("co-tenant loops failed: %s" % b["errors"])
    metrics_doc = json.loads(_get(base_url + "/metrics"))
    prom = _get(base_url + "/metrics?format=prometheus")
    server.stop()
    sched.stop()
    wf.thread_pool.shutdown()
    # the HTTP handler threads end with their connections: give them a
    # moment, then every thread this phase started must be gone
    deadline = time.monotonic() + 10
    while True:
        leaked = [t for t in set(threading.enumerate()) - threads_before
                  if t.is_alive()]
        if not leaked or time.monotonic() > deadline:
            break
        time.sleep(0.05)

    # -- checks ----------------------------------------------------------
    for what, got, want in (("A", a["losses"], solo_losses),
                            ("B", b["losses"], lone_losses)):
        if got != want:
            raise AssertionError("window %s: co-tenant LM losses %s != "
                                 "solo %s" % (what, got, want))
    for what, runs in (("A", a["served"]), ("B", b["served"])):
        for run in runs:
            if run != serve["staggered"]:
                raise AssertionError("window %s greedy tokens %r != phase "
                                     "3's %r" % (what, run,
                                                 serve["staggered"]))
    # each dispatched /apply batch against the engine on the same rows,
    # outside the scheduler; each answer is one of its row's outputs
    outputs = {}
    for idx, out in recorder.batches:
        if None in idx or not np.array_equal(
                out, alex.apply(np.stack([rows[j] for j in idx]))):
            raise AssertionError("an /apply batch (rows %s) differs from "
                                 "the unscheduled engine's" % (idx,))
        for j, row in zip(idx, out):
            outputs.setdefault(j, []).append(row)
    answers += a["apply"] + b["apply"]
    if sum(len(idx) for idx, _ in recorder.batches) != len(answers):
        raise AssertionError("%d /apply answers for %d dispatched rows" % (
            len(answers), sum(len(idx) for idx, _ in recorder.batches)))
    for j, got in answers:
        if not any(np.array_equal(got, row) for row in outputs[j]):
            raise AssertionError("/apply client %d got a row no batch "
                                 "gave" % j)
    for name in ("train", "serve", "apply", "graph"):
        if not a["tenants"][name]["quanta"]:
            raise AssertionError("tenant %s got no quanta: %s"
                                 % (name, a["tenants"]))
    want_graph = 2 * GRAPH_PASSES * a["graph_runs"]
    if a["tenants"]["graph"]["quanta"] != want_graph or \
            launches["uniform_fill"] != GRAPH_PASSES * a["graph_runs"]:
        raise AssertionError("graph tenant: %d quanta, %d fills for %d runs"
                             % (a["tenants"]["graph"]["quanta"],
                                launches["uniform_fill"], a["graph_runs"]))
    if a["tenants"]["train"]["quanta"] != COTENANT_WINDOWS:
        raise AssertionError("train tenant quanta %s"
                             % a["tenants"]["train"])
    if leaked:
        raise AssertionError("threads still running after Scheduler.stop()"
                             ": %s" % [t.name for t in leaked])
    if "veles_sched_quanta_total" not in prom or \
            set(metrics_doc["_scheduler"]["tenants"]) != {
                "train", "serve", "apply", "graph"}:
        raise AssertionError("/metrics lacks the scheduler")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                 "flash_decode", "lrn_fwd", "uniform_fill"):
        if not launches.get(name):
            raise AssertionError("%s not launched in the co-tenancy window"
                                 % name)

    # -- numbers ---------------------------------------------------------
    # the first window of each run captures the step: not timed
    solo_timed, cot_timed = solo_walls[1:], a["train_walls"][1:]
    solo_tps = tok_per_window * 1e3 / float(np.mean(solo_timed))
    cot_tps = tok_per_window * 1e3 / float(np.mean(cot_timed))
    phase3_decode = serve["http"]["metrics"]["decode_ms"]
    cot_apply = latency_stats(a["apply_ms"])
    leased_b = sum(t["device_ms"] for t in b["tenants"].values())
    accounting = dict(window_ms=b["wall_ms"], leased_ms=leased_b,
                      busy_ms=b.get("busy_ms"),
                      busy_over_leased=b.get("busy_ms", 0) / leased_b,
                      busy_share=b.get("busy_ms", 0) / b["wall_ms"],
                      tenants=b["tenants"])
    leased_a = sum(t["device_ms"] for t in a["tenants"].values())
    tenants = {}
    for name, row in snap_a["tenants"].items():
        wait = dict(row["queue_wait_ms"], n=row["quanta"])
        if row["quanta"] < TAIL_MIN_SAMPLES:
            wait["p99"] = None
        tenants[name] = dict(a["tenants"][name],
                             share=a["tenants"][name]["device_ms"] /
                             leased_a, queue_wait_ms=wait, snapshot=row)
    for name, row in tenants.items():
        wait = row["queue_wait_ms"]
        log("  tenant %s, window A: %d quanta, %.1f device-ms (leased), "
            "share %.3f, %d preemptions; since set-up: %d quanta, %.1f "
            "device-ms, wait p50 %.3f ms, %s" % (
                name, row["quanta"], row["device_ms"], row["share"],
                row["preemptions"], row["snapshot"]["quanta"],
                row["snapshot"]["device_ms"], wait["p50"],
                "p99 %.3f ms" % wait["p99"] if wait["p99"] is not None
                else "p99 not read (n=%d)" % wait["n"]))
    log("  LM: %.1f tokens/s co-tenant (%d timed windows, %.1f-%.1f ms) "
        "against %.1f solo here (%.1f-%.1f ms) and %.1f in phase 5: "
        "%.3fx; losses == the solo run's bitwise in windows A and B; a "
        "window free-running %.1f ms, as a lone tenant %.1f ms [%s]" % (
            cot_tps, len(cot_timed), min(cot_timed), max(cot_timed),
            solo_tps, min(solo_timed), max(solo_timed),
            train["tokens_per_s"], cot_tps / solo_tps,
            float(np.mean(solo_timed)), float(np.mean(lone_walls)), card))
    log("  decode round (batcher, wait included) co-tenant p50 %.3f, %s "
        "(n=%d) against p50 %.3f, %s (n=%d) alone on this server (phase "
        "3: %.3f / %.3f); greedy tokens == phase 3's (staggered) in all "
        "%d + %d + %d runs" % (
            cot_decode["p50"], "p99 %.3f ms" % cot_decode["p99"]
            if cot_decode["p99"] is not None else "p99 not read",
            cot_decode["n"], solo_decode["p50"],
            "p99 %.3f ms" % solo_decode["p99"]
            if solo_decode["p99"] is not None else "p99 not read",
            solo_decode["n"], phase3_decode["p50"], phase3_decode["p99"],
            len(solo["generate"]), len(a["served"]), len(b["served"])))
    log("  /apply request (%d clients, one row each) co-tenant %s against "
        "%s alone on this server and %.3f ms for bucket 1 in phase 11; "
        "%d batches == the unscheduled engine's bitwise" % (
            APPLY_CLIENTS, fmt_stats(cot_apply), fmt_stats(solo_apply),
            apply["per_bucket"][1]["captured_ms"]["p50"],
            len(recorder.batches)))
    log("  graph tenant: %d runs of %d passes, %d quanta" % (
        a["graph_runs"], GRAPH_PASSES, a["tenants"]["graph"]["quanta"]))
    log("  profiled window: %.1f ms wall, tenants' leased device-ms %.1f, "
        "card busy %.1f ms (busy / leased %.3f, busy share %.3f) [%s]" % (
            accounting["window_ms"], leased_b, accounting["busy_ms"] or 0,
            accounting["busy_over_leased"], accounting["busy_share"], card))
    log("  launches in window A: %s; Scheduler.stop() left no thread "
        "running" % {k: v for k, v in launches.items() if v})
    return dict(tenants=tenants, memory_bytes=mem,
                lm=dict(tokens_per_s=cot_tps, solo_tokens_per_s=solo_tps,
                        ratio=cot_tps / solo_tps,
                        phase5_tokens_per_s=train["tokens_per_s"],
                        window_ms=a["train_walls"],
                        solo_window_ms=solo_walls,
                        lone_tenant_window_ms=lone_walls,
                        losses=a["losses"] + b["losses"]),
                decode=dict(cotenant=cot_decode, alone=solo_decode,
                            phase3=phase3_decode),
                apply=dict(cotenant=cot_apply, alone=solo_apply,
                           clients=APPLY_CLIENTS,
                           batches=len(recorder.batches),
                           phase11_bucket1_p50_ms=apply["per_bucket"][1][
                               "captured_ms"]["p50"]),
                graph_runs=a["graph_runs"], window_a_ms=a["wall_ms"],
                accounting=accounting), launches


# ---------------------------------------------------------------------------
# phase 14: the classifier through the unit graph at full width
# ---------------------------------------------------------------------------

#: phase 14: AlexNetWorkflow's own defaults (1000 classes, 224 x 224 x 3,
#: minibatch 128, lr 0.01, momentum 0.9, weight decay 5e-4, f32 params,
#: bf16 compute) over SyntheticColorImagesLoader, the dataset cut to
#: these many images (no width changes), for two TRAIN passes
UG_DATA = dict(n_train=1024, n_valid=256)
UG_EPOCHS = 2
UG_SEED = 42
#: the launches of one minibatch through the unit graph: two LRN layers
#: forward (K6), their two backward units (K7, no K6) and two dropout
#: masks (K8) on TRAIN; the forward's two K6 only on VALID
UG_TRAIN_LAUNCHES = {"lrn_fwd": 2, "lrn_bwd": 2, "uniform_fill": 2}
UG_VALID_LAUNCHES = {"lrn_fwd": 2}
#: minibatches under the profiler (single passes through the graph)
UG_PROFILED = 4
#: phase 15: the 10-class 64 x 64 AlexNetWorkflow at f32, dropout 0.5,
#: one epoch, once on the card through the kernels and once on the CPU
#: through the plain versions
UG_PARITY = dict(n_classes=10, image_size=64, max_epochs=1,
                 loader_kwargs=dict(n_train=60, n_valid=20,
                                    minibatch_size=20, image_size=64))


def _ug_hooks(wf, counters, records, losses, gc_ms):
    """Record, at the start of every minibatch (the loader's run), the
    host clock, the launch counters, every unit's run time so far, the
    garbage collector's pauses so far and the minibatch's class and
    epoch; and every minibatch's (class, n_err, loss) after the
    evaluator. ``gc_ms`` is a one-element list the caller's gc callback
    adds each collection's milliseconds to."""
    loader, evaluator = wf.loader, wf.evaluator
    serve, evaluate = loader.run, evaluator.run

    def serving():
        records.append((time.perf_counter(), counters.read(),
                        {u.name: u.total_run_time_ for u in wf.units},
                        gc_ms[0]))
        serve()
        records[-1] += (loader.minibatch_class, loader.epoch_number)

    def evaluating():
        evaluate()
        losses.append((loader.minibatch_class, evaluator.n_err,
                       evaluator.loss, loader.minibatch_size))

    loader.run = serving
    evaluator.run = evaluating


def unit_graph_classifier_phase(torch, counters, dev, card, fused):
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import CudaDevice, Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.alexnet import AlexNetWorkflow

    log("phase 14: the classifier through the unit graph: AlexNetWorkflow "
        "(1000 classes, 224 x 224 x 3, minibatch 128, lr 0.01, momentum "
        "0.9, weight decay 5e-4, f32 params, %s compute) on Device(), "
        "SyntheticColorImagesLoader cut to %s, %d TRAIN passes"
        % (root.common.engine.compute_type, UG_DATA, UG_EPOCHS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    root.common.random.seed = UG_SEED
    prng.reset()
    t0 = time.monotonic()
    device = Device()
    if not isinstance(device, CudaDevice):
        raise AssertionError("Device() is %r, not the card" % (device,))
    wf = AlexNetWorkflow(max_epochs=UG_EPOCHS, loader_kwargs=dict(UG_DATA))
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    mbs = wf.loader.max_minibatch_size
    records, losses, gc_ms = [], [], [0.0]
    _ug_hooks(wf, counters, records, losses, gc_ms)
    gc_started = []

    def gc_pause(phase, info):
        if phase == "start":
            gc_started.append(time.perf_counter())
        elif gc_started:
            gc_ms[0] += (time.perf_counter() - gc_started.pop()) * 1e3

    gc.callbacks.append(gc_pause)
    counters.reset()
    t0 = time.monotonic()
    try:
        wf.run()
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(gc_pause)
    run_s = time.monotonic() - t0
    records.append((time.perf_counter(), counters.read(),
                    {u.name: u.total_run_time_ for u in wf.units},
                    gc_ms[0], None, None))
    launches = counters.read()

    # per minibatch, from its serve to the next: the time, the launches,
    # the three units that took longest and the collector's pauses
    per_mb = []
    for (t_a, c_a, u_a, g_a, klass, epoch), (t_b, c_b, u_b, g_b, _, _) in \
            zip(records, records[1:]):
        delta = {k: c_b[k] - c_a[k] for k in c_b if c_b[k] != c_a[k]}
        units = sorted(((u_b[n] - u_a.get(n, 0.0)) * 1e3, n) for n in u_b)
        per_mb.append(dict(klass=klass, epoch=epoch,
                           ms=(t_b - t_a) * 1e3, launches=delta,
                           gc_ms=g_b - g_a,
                           slowest_units=[(n, ms) for ms, n in
                                          units[::-1][:3]]))
    for mb in per_mb:
        want = UG_TRAIN_LAUNCHES if mb["klass"] == 2 else UG_VALID_LAUNCHES
        if mb["launches"] != want:
            raise AssertionError("a %s minibatch of epoch %d launched %s, "
                                 "not %s" % ("TRAIN" if mb["klass"] == 2
                                             else "VALID", mb["epoch"],
                                             mb["launches"], want))
    n_train = sum(mb["klass"] == 2 for mb in per_mb)
    n_valid = sum(mb["klass"] == 1 for mb in per_mb)
    train_ms = [mb["ms"] for mb in per_mb
                if mb["klass"] == 2 and mb["epoch"] == UG_EPOCHS - 1]
    valid_ms = [mb["ms"] for mb in per_mb
                if mb["klass"] == 1 and mb["epoch"] >= UG_EPOCHS - 1]
    train_p50 = float(np.percentile(train_ms, 50))
    valid_p50 = float(np.percentile(valid_ms, 50))
    images_per_s = mbs * 1e3 / train_p50
    log("  set-up %.1f s (data %s on the card); %d TRAIN and %d VALID "
        "minibatches in %.2f s; launches %s" % (
            setup_s, tuple(wf.loader._dataset_dev_.shape), n_train,
            n_valid, run_s, {k: v for k, v in launches.items() if v}))
    log("  launches per minibatch: TRAIN %s, VALID %s (every one of them)"
        % (UG_TRAIN_LAUNCHES, UG_VALID_LAUNCHES))
    log("  ms per minibatch (p50, epoch %d): TRAIN %.3f (%s; mean %.3f), "
        "VALID %.3f (%s); %.1f images/s training at the p50 (%.1f at the "
        "mean), against %.1f images/s of the fused step (phase 9, batch %d)"
        " [%s]" % (
            UG_EPOCHS - 1, train_p50, ", ".join("%.1f" % v for v in
                                                train_ms),
            float(np.mean(train_ms)), valid_p50,
            ", ".join("%.1f" % v for v in valid_ms), images_per_s,
            mbs * 1e3 / float(np.mean(train_ms)), fused["images_per_s"],
            fused["batch"], card))
    for mb in per_mb:
        if mb["klass"] == 2 and mb["epoch"] == UG_EPOCHS - 1:
            log("    TRAIN %.1f ms: gc %.1f ms; slowest units %s" % (
                mb["ms"], mb["gc_ms"], ", ".join(
                    "%s %.1f" % u for u in mb["slowest_units"])))

    train_losses = [(loss / size) for klass, _, loss, size in losses
                    if klass == 2]
    per = -(-UG_DATA["n_train"] // mbs)
    per_epoch = [float(np.mean(train_losses[i * per:(i + 1) * per]))
                 for i in range(UG_EPOCHS)]
    n_err = {k: list(v) for k, v in wf.decision.epoch_errors.items()}
    log("  TRAIN loss per image: %s" % ", ".join(
        "%.4f" % v for v in train_losses))
    log("  mean TRAIN loss per epoch %s; errors %% by epoch: VALID %s, "
        "TRAIN %s" % (["%.4f" % v for v in per_epoch], n_err[1], n_err[2]))
    if not all(np.isfinite(train_losses)):
        raise AssertionError("non-finite losses: %s" % train_losses)
    # falling from the untrained model's: at minibatch 128 with lr 0.01
    # and momentum 0.9 the per-minibatch loss is not monotonic (the
    # first minibatch of the second pass spikes on the card), so the
    # run's last loss is held below its first
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError("the losses did not fall: %s" % train_losses)
    if not bool(wf.decision.complete):
        raise AssertionError("the decision did not complete")
    stats = wf.get_unit_run_time_stats()
    log("  slowest units (host wall, every call): %s" % "; ".join(
        "%s %d x %.3f ms" % (name, calls, avg * 1e3)
        for name, _, calls, avg in stats[:8]))
    evaluator = next(s for s in stats if s[0] == wf.evaluator.name)
    log("  the evaluator's one host read a minibatch (a sync: it waits for "
        "the forward): %.3f ms a call" % (evaluator[3] * 1e3))
    peak = torch.cuda.max_memory_allocated()

    # the device's busy share over single passes (TRAIN minibatches
    # of the next pass) through the same graph
    wf.resume_overrides(max_epochs=UG_EPOCHS + 1)
    wf.prepare_single_pass()

    def one_pass():
        wf.run()
        torch.cuda.synchronize()

    prof = profile_device(torch, one_pass, UG_PROFILED, host_ops=False)
    if prof is None:
        log("  profile: no device time recorded")
    else:
        log("  profile of %d single passes (TRAIN): wall %.3f ms, device "
            "%.3f ms a minibatch (busy %.0f%%); by class: %s" % (
                UG_PROFILED, prof["wall_ms"], prof["device_ms"],
                100 * prof["busy_share"], "; ".join(
                    "%s %.3f ms" % kv for kv in sorted(
                        prof["by_class"].items(), key=lambda kv: -kv[1]))))
    log("  peak memory %.2f GB [%s]" % (peak / 1e9, card))
    wf.thread_pool.shutdown()
    del wf
    return dict(data=UG_DATA, epochs=UG_EPOCHS, minibatch=mbs,
                setup_s=setup_s, run_s=run_s, train_minibatches=n_train,
                valid_minibatches=n_valid, train_ms=train_ms,
                valid_ms=valid_ms, train_p50_ms=train_p50,
                valid_p50_ms=valid_p50, images_per_s=images_per_s,
                fused_images_per_s=fused["images_per_s"],
                train_losses=train_losses, epoch_errors=n_err,
                unit_stats=[list(s) for s in stats],
                evaluator_ms=evaluator[3] * 1e3, peak_mem_bytes=peak,
                profile=prof, per_minibatch=per_mb), launches


# ---------------------------------------------------------------------------
# phase 15: unit-graph parity on the card, kernels vs plain on the CPU
# ---------------------------------------------------------------------------

def _ug_parity_run(device):
    """One epoch of UG_PARITY at f32 on ``device`` from UG_SEED: every
    minibatch's (class, n_err, loss), every TRAIN minibatch's two
    dropout masks, and the parameters and velocities after it."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                                alexnet_layers)
    from veles_tpu_torch.nn.dropout import Dropout

    root.common.random.seed = UG_SEED
    prng.reset()
    wf = AlexNetWorkflow(layers=alexnet_layers(10, dropout=0.5),
                         **UG_PARITY)
    wf.initialize(device=device)
    losses, masks = [], []
    evaluate = wf.evaluator.run

    def evaluating():
        evaluate()
        losses.append((wf.loader.minibatch_class, wf.evaluator.n_err,
                       wf.evaluator.loss))

    wf.evaluator.run = evaluating
    for unit in wf.forwards:
        if isinstance(unit, Dropout):
            drop = unit.run

            def dropping(unit=unit, drop=drop):
                drop()
                if unit.minibatch_class == 2:
                    masks.append(np.array(unit.mask.map_read()))

            unit.run = dropping
    wf.run()
    leaves = {}
    for gd in wf.gds:
        if getattr(gd, "velocity_weights", None):
            for attr in ("weights", "bias", "velocity_weights",
                         "velocity_bias"):
                leaves["%s.%s" % (gd.name, attr)] = np.array(
                    getattr(gd, attr).map_read())
    wf.thread_pool.shutdown()
    return losses, masks, leaves


def unit_graph_parity_phase(torch, dev, card):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root

    log("phase 15: unit-graph parity, AlexNetWorkflow (10 classes, 64 x 64) "
        "f32, minibatch 20, dropout 0.5, one epoch from seed %d: Device() "
        "through the kernels vs Device(backend='cpu') through the plain "
        "versions" % UG_SEED)
    saved = root.common.engine.compute_type
    root.common.engine.compute_type = "float32"
    try:
        t0 = time.monotonic()
        card_run = _ug_parity_run(Device())
        card_s = time.monotonic() - t0
        t0 = time.monotonic()
        cpu_run = _ug_parity_run(Device(backend="cpu"))
        cpu_s = time.monotonic() - t0
    finally:
        root.common.engine.compute_type = saved
    (lk, mk, pk), (lp, mp, pp) = card_run, cpu_run
    if len(mk) != len(mp) or not mk or \
            not all(np.array_equal(a, b) for a, b in zip(mk, mp)):
        raise AssertionError("the dropout masks differ (%d vs %d)"
                             % (len(mk), len(mp)))
    if [r[:2] for r in lk] != [r[:2] for r in lp]:
        raise AssertionError("classes / n_err per minibatch %s != %s"
                             % ([r[:2] for r in lk], [r[:2] for r in lp]))
    loss_err = max(abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(lk, lp))

    def share(a, b):
        return float(np.abs(a.astype(np.float64) - b).max() /
                     max(np.abs(b).max(), 1e-30))

    # the weights, and the biases and velocities, which start at 0 and
    # sum their layer's gradients: a ReLU whose input lies within
    # rounding of 0 on either side would take slope 1 on one and 0 on
    # the other and move one column of a gradient by a whole sample's
    # share (1e-3 to 2e-2 of the scale between the port and the
    # reference on the CPU, tests/test_torch_standard.py); on these
    # inputs no ReLU does
    weight_err = max(share(pk[k], pp[k]) for k in pk
                     if k.endswith(".weights"))
    summed_err = max(share(pk[k], pp[k]) for k in pk
                     if not k.endswith(".weights"))
    log("  %d minibatches, %d dropout masks bitwise equal; n_err %s; card "
        "%.1f s, CPU %.1f s" % (len(lk), len(mk), [r[1] for r in lk],
                                card_s, cpu_s))
    check("unit-graph losses, card vs CPU (relative)", loss_err,
          TOL_CLASSIFIER["float32"])
    check("unit-graph weights after the epoch (share of each one's scale)",
          weight_err, TOL_CLASSIFIER["float32"])
    check("unit-graph velocities and biases after the epoch (share of "
          "each one's scale)", summed_err, TOL_CLASSIFIER["float32"])
    return dict(minibatches=len(lk), masks=len(mk),
                n_err=[r[1] for r in lk], loss_rel_err=loss_err,
                weight_rel_err=weight_err, summed_rel_err=summed_err,
                card_s=card_s, cpu_s=cpu_s)


class Counters:
    """Every kernel's launch counter, read and reset together."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self):
        for mod in self.modules:
            mod.reset_launches()

    def read(self):
        out = {}
        for mod in self.modules:
            out.update(mod.LAUNCHES)
        return out

    def delta(self, before):
        now = self.read()
        return {kk: now[kk] - before.get(kk, 0) for kk in now}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from veles_tpu_torch.ops import _build
        from veles_tpu_torch.ops import flash_attention as fa
        from veles_tpu_torch.ops import lrn as lrn_ops
        from veles_tpu_torch.ops import rng as rng_ops
    except ImportError as e:
        print("chip_smoke: the port is not beside this script (%s)" % e,
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.monotonic()
    card = card_line()
    log("phase 1: card %s; torch %s, CUDA %s" % (
        card, torch.__version__, torch.version.cuda))
    t0 = time.monotonic()
    _build.build()
    build_s = time.monotonic() - t0
    log("  built %s in %.1f s" % (_build.sources(), build_s))
    for name in _build.sources():
        for kernel, lines in ptxas_usage(_build.build_log(name)).items():
            if not kernel.startswith(SUMMED_KERNELS):
                log("    %s %s: %s" % (name, kernel, "; ".join(lines)))
    hopper = hopper_units(_build, fa)

    rows = kernel_phase(torch, fa, dev)
    rows.update(lrn_fill_kernels(torch, dev))
    log("  profiler readings taken again (records lost): %d" % RETAKES[0])
    serve, serve_launches = serving_phase(torch, fa, dev, card)
    parity = parity_phase(torch, dev)
    train, train_launches = training_phase(torch, fa, dev, card)
    train_parity = train_parity_phase(torch, dev)
    paged, paged_launches = paged_serving_phase(torch, fa, dev, card, serve)
    paged_parity = paged_parity_phase(torch, fa, dev, card)
    counters = Counters(fa, lrn_ops, rng_ops)
    classifier, classifier_launches = classifier_phase(torch, counters, dev,
                                                       card)
    classifier_parity = classifier_parity_phase(torch, dev)
    apply, apply_launches = apply_phase(torch, counters, dev, card)
    graph, graph_launches, graph_objs = unit_graph_phase(torch, counters,
                                                         dev, card)
    cotenancy, cotenancy_launches = cotenancy_phase(
        torch, counters, dev, card, serve, train, apply, graph_objs)
    classifier_graph, classifier_graph_launches = \
        unit_graph_classifier_phase(torch, counters, dev, card, classifier)
    classifier_graph_parity = unit_graph_parity_phase(torch, dev, card)

    # each main path's launches, counted from 0 around that path alone
    by_path = {"serving": serve_launches, "training": train_launches,
               "paged serving": paged_launches,
               "classifier training": classifier_launches,
               "apply serving": apply_launches,
               "unit graph": graph_launches,
               "co-tenancy": cotenancy_launches,
               "unit-graph classifier": classifier_graph_launches}
    kernels = []
    for name, row in rows.items():
        paths = {p: n.get(name, 0) for p, n in by_path.items()
                 if n.get(name, 0)}
        if not paths:
            raise AssertionError("%s was launched on no main path" % name)
        row = dict(row, launches=sum(paths.values()),
                   launches_by_path=paths)
        row["max_err"] = row["max_abs_err"]
        row["kernel_ms"] = row["ms"]
        kernels.append(row)
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  hopper_units=hopper,
                  kernels=kernels, serving=serve, parity=parity,
                  training=train, training_parity=train_parity,
                  paged_serving=paged, paged_parity=paged_parity,
                  classifier=classifier,
                  classifier_parity=classifier_parity, apply=apply,
                  unit_graph=graph, cotenancy=cotenancy,
                  unit_graph_classifier=classifier_graph,
                  unit_graph_parity=classifier_graph_parity,
                  wall_s=time.monotonic() - t_start)
    os.makedirs("chip_smoke_out", exist_ok=True)
    with open(os.path.join("chip_smoke_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        RC = main()
    except BaseException:  # noqa: BLE001 — any failed phase fails the run
        # a phase that raised may leave service threads (an HTTP
        # listener, a batcher's dispatch loop, a tenant's loop) running:
        # exit now, non-zero, instead of waiting on them
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(RC)
