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
   the epoch within stated bounds;
16. the flagship's input pipeline at full width, as bench.py measures
   it: ``alexnet_fused()`` (phase 9's configuration, batch 1536, bf16)
   and ``FullBatchLoader``s of 2 x 1536 uint8 224 x 224 x 3 images on
   ``Device()`` with ``range_linear`` (0..255 -> 0..1), four legs in 3
   interleaved windows of 48 steps: resident (``step`` on one device
   batch), pipeline (``make_loader_step``, one step a call), overlap
   fused (``make_loader_step(steps_per_dispatch=8)``) and overlap
   prefetch (``PrefetchingServer(depth=2)`` with a bf16 cast ->
   ``get_many(8)`` -> ``step_many``): images/s per leg (best and mean
   window), ``pipeline_vs_resident``, ``loader_overlap_efficiency``
   of both overlap legs, per-step wall p50/p99/max; exactly 2/2/2
   K6/K7/K8 around a loader step and 16/16/16 around a K = 8 dispatch;
   one profiled window of the resident, pipeline and overlap-fused
   legs (busy share, time by kernel class), the gather + normalize's
   device time (and its index_select's and normalizer's), peak memory,
   the ring's staged bytes, finite losses, no producer thread after
   ``stop()``; the first gathered minibatch bitwise the loader's own
   serve; under deterministic cuDNN, the K = 1 loader step against
   ``loader.run()`` + ``step`` and one K = 8 dispatch against 8 loader
   steps, bitwise over 8 steps; ``MeanDispNormalizer`` and
   ``InputJoiner`` on the card against the CPU, bitwise;
17. the four unit families and the model zoo on ``Device()`` (f32
   params, bf16 compute), one epoch each from seed 42:
   ``VggWorkflow(depth=16)`` at its defaults (32 x 32 x 3 synthetic
   colour images, 5,000 TRAIN and 1,000 VALID, minibatch 50, FC 4096 x 2
   with dropout 0.5, lr 0.01, momentum 0.9, weight decay 5e-4),
   ``ConvAutoencoderWorkflow()`` and ``AutoencoderWorkflow()`` (28 x 28
   synthetic digits), the row-wise LSTM classifier (``StandardWorkflow``
   of an ``lstm`` of 128 and a softmax of 10: 28 steps of 28 pixels),
   ``LenetWorkflow``, ``CifarWorkflow`` and ``Stl10Workflow`` (its dataset
   cut to 1,000 TRAIN and 200 VALID images); then ``RBM(n_hidden=500)``
   with ``RBMTrainer`` and the 8 x 8 ``KohonenForward`` with
   ``KohonenTrainer``, 60 steps each over minibatches of 100 rows of the
   digits' TRAIN set: K8 bitwise against its plain version at this
   path's fill shapes first; then per model the parameter count, ms a
   TRAIN and VALID minibatch (p50, p99), images/s, the launches of every
   minibatch (exactly 2 K8 a VGG-16 TRAIN minibatch, 1 an STL-10 one, 1
   a CD-1 step, none elsewhere and none on VALID), the device time of a
   TRAIN minibatch by kernel class and its busy share, peak memory, the
   errors by epoch and the first and last losses, all finite; VGG-16's
   losses and the RBM's and SOM's errors must fall;
18. the unit families and the zoo, card against CPU at f32: the conv
   autoencoder and the LSTM classifier (600 TRAIN, 200 VALID, widths
   kept) for one epoch on ``Device()`` and on ``Device(backend="cpu")``
   from one seed: classes per minibatch equal, the LSTM's n_err equal,
   RMSEs, losses, errors by epoch and ``params_of`` within stated
   bounds; one ``RBMTrainer`` step, its K8 fill bitwise the CPU's plain
   fill; three ``KohonenTrainer`` steps, the winners equal; ``Deconv``
   with two ``GDDeconv`` steps and ``Depooling`` with ``GDDepooling`` at
   the conv autoencoder's shapes;
19. the state half at full width: K6/K7 at AlexNet's two LRN shapes at
   minibatch 128 (bf16) and K8 at [128, 4096] against their plain
   versions (K1-K3 at the LM's training shape are phase 2's); then, the
   counts from 0, (a) phase 5's LM (``FULL``, bf16, remat "attn", batch
   8, lr 1e-4) trained by ``TransformerWorkflow`` over
   ``SyntheticTextLoader`` (88 windows: 10 TRAIN and 1 VALID minibatch
   an epoch) with ``Snapshotter(sharded=True)``, 3 epochs (run A): ms
   per TRAIN step beside phase 5's, exactly 24/12/12 K1/K2/K3 a TRAIN
   step after the one that captures and 12 K1 a VALID minibatch, each
   save's non-finite guard and its time on the training thread beside
   the writer's time and bytes, peak memory; the epoch-2 manifest loaded
   in a process that sees no card (``CUDA_VISIBLE_DEVICES=""``); run A
   freed, run B resumed from that manifest to the end: its params and
   Adam state against run A's, bitwise or within the JAX package's
   rtol 1e-5 / atol 1e-6 (which held is logged); (b) phase 14's
   ``AlexNetWorkflow`` through ``train_fused`` for its two epochs:
   exactly 2/2/2 K6/K7/K8 a step, device ms a step and images/s beside
   phases 14 and 9, ``write_back`` and one unit-graph VALID pass against
   the fused forward of the written-back params (the errors of
   ``train_fused``'s closing sweep; rows whose argmax differ must lie
   within bf16 rounding of a tie), a ``compression=None`` snapshot and
   gzip's rate at the codec's level over 16 slices of it,
   ``InferenceEngine.from_snapshot`` against ``from_workflow`` bitwise
   (2 K6 a replay) and one ``POST /apply`` on the restored engine;
20. the state half, card against CPU at f32: the LM workflow (the JAX
   package's default configuration, its corpus cut to 8 minibatches)
   for 2 epochs, ``train_fused(MnistWorkflow)``, an ensemble of 3 MNIST
   members and the genetics optimizer (population 6, 2 generations,
   each evaluation a small MNIST training run) under a ``Scheduler``
   tenant whose quanta must equal the evaluations, each check within
   the CPU tests' bounds;
21. the mesh on one card (``veles_tpu_torch.parallel``): two ranks
   spawned on this card, joined over gloo with their collectives staged
   through host memory (NCCL refuses two ranks on one card), each leg
   against one rank: (a) ``alexnet_fused()`` (batch 1536, bf16,
   bench.py's lr/momentum/decay) at ``data=2`` and at ``model=2`` (the
   reference's Megatron layout), 3 steps, params within
   ``TOL_CLASSIFIER["bfloat16"]`` of the one-rank steps' update, or twice
   bf16's own rounding of those steps where larger (measured: the
   one-rank f32 steps against the bf16 ones), and at 64 x 64 f32 within
   1e-4 of each leaf's scale, the dropout masks bitwise the one-rank
   masks, exactly 2 each of
   K6/K7/K8 a rank a step; (b) the LM (``FULL``, batch 8, bf16, remat
   "attn") at ``seq=2``, 3 steps, losses within ``TOL_MESH_LM`` of the
   one-rank eager steps, exactly 2 L h K1 and L h each of K2/K3 a step
   on a rank whose ring has h hops to compute (1 and 2), and the f32
   2-layer ring's gradients through K1-K3 against the plain path;
   (c) ``FULL``'s widths with 2 experts at ``model=2``, depth cut to
   ``MESH_MOE_LAYERS``; (d) the JAX package's pipeline configuration
   at 2 stages against ``reference_loss_fn``; (e) (a)'s data-parallel
   step over NCCL with one rank, bitwise the unsharded step. Each leg's
   step p50 and the gloo bytes staged a step are logged; the two ranks
   time-share the card, so the times say nothing of scaling over cards.

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


# ---------------------------------------------------------------------------
# phase 16: the flagship's input pipeline at full width
# ---------------------------------------------------------------------------

#: bench.py's legs: 3 interleaved windows of 48 steps, K = 8 steps a
#: dispatch, a prefetch ring of depth 2; the parity runs take 8 steps
PIPE_WINDOWS = 3
PIPE_STEPS = 48
PIPE_K = 8
PIPE_DEPTH = 2
PIPE_PARITY_STEPS = 8
PIPE_IMAGE = (224, 224, 3)
#: the small units held card against CPU: MeanDispNormalizer over a
#: minibatch of the flagship's images, InputJoiner of its output and a
#: [rows, 1000] block
PIPE_UNIT_ROWS = 64
PIPE_LEGS = ("resident", "pipeline", "overlap-fused", "overlap-prefetch")


def _synth_images(batch, seed, device):
    """bench.py:103-131: a FullBatchLoader of 2 x ``batch`` uint8
    images and labels from ``default_rng(seed)``, all TRAIN,
    range_linear 0..255 -> 0..1, no shuffle, on ``device`` (a unit
    Device)."""
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.loader import TRAIN, FullBatchLoader

    n = 2 * batch
    rng = np.random.default_rng(seed)

    class SynthImages(FullBatchLoader):
        def load_data(self):
            self.has_labels = True
            self.original_data = rng.integers(
                0, 256, (n,) + PIPE_IMAGE, dtype=np.uint8)
            self.original_labels = rng.integers(0, 1000, n).astype(
                np.int32)
            self.class_lengths[:] = [0, 0, n]

    loader = SynthImages(
        AcceleratedWorkflow(None, name="synth-images"), minibatch_size=batch,
        shuffle_limit=0, normalization_type="range_linear",
        normalization_parameters=dict(source=(0.0, 255.0),
                                      interval=(0.0, 1.0)))
    if loader.initialize(device=device) is not None:
        raise AssertionError("the synthetic image loader did not "
                             "initialize")
    loader.minibatch_class = TRAIN
    return loader


def _pipe_trainer(dev):
    from veles_tpu_torch.models import flagship
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    specs, params, fwd_flops = flagship.alexnet_fused()
    return FusedClassifierTrainer(specs, params, device=dev,
                                  **CLASSIFIER_HYPER), fwd_flops


def _leg_window(torch, dispatch, n_dispatch, k):
    """One timed window: ``n_dispatch`` calls of ``dispatch`` (K steps
    each), the last one synchronized. Returns (ms per step, the wall of
    each step as the host saw it (a dispatch's over K), the last
    metrics)."""
    per_step = []
    t0 = last = time.monotonic()
    for i in range(n_dispatch):
        metrics = dispatch()
        if i == n_dispatch - 1:
            torch.cuda.synchronize()
        now = time.monotonic()
        per_step.extend([(now - last) * 1e3 / k] * k)
        last = now
    return (now - t0) * 1e3 / (n_dispatch * k), per_step, metrics


def _trajectory(torch, dev, loader_seed, batch, mode):
    """``PIPE_PARITY_STEPS`` steps of a fresh trainer over a fresh
    loader: ``loader`` (K = 1 make_loader_step), ``two-dispatch``
    (loader.run() + step on the served batch) or ``k`` (one K =
    PIPE_PARITY_STEPS dispatch). Returns (losses, params, velocity)."""
    from veles_tpu_torch.backends import Device
    trainer, _ = _pipe_trainer(dev)
    loader = _synth_images(batch, loader_seed, Device())
    losses = []
    if mode == "k":
        step = trainer.make_loader_step(
            loader, steps_per_dispatch=PIPE_PARITY_STEPS)
        losses = list(step()["loss"])
    else:
        step = trainer.make_loader_step(loader) if mode == "loader" \
            else None
        for _ in range(PIPE_PARITY_STEPS):
            loader.run()
            m = step() if step is not None else trainer.step(
                loader.minibatch_data.devmem, loader.minibatch_labels.devmem)
            losses.append(m["loss"])
    torch.cuda.synchronize()
    return torch.stack(losses), trainer.params, trainer.velocity


def _bitwise_trees(torch, a, b):
    return all(torch.equal(x[key], y[key]) for x, y in zip(a, b)
               for key in x)


def _pipeline_parity(torch, dev, batch):
    """The gathered window against the loader's own serve, then the
    trajectories under deterministic cuDNN: (a) the K = 1 loader step
    against loader.run() + step, (b) one K = 8 dispatch against 8 K = 1
    loader steps; bitwise, cuDNN's settings restored after."""
    from veles_tpu_torch.backends import Device
    served = _synth_images(batch, 2, Device())
    fused = _synth_images(batch, 2, Device())
    fused.external_gather = True
    served.run()
    fused.run()
    x, labels = fused.gather(fused.minibatch_offset - fused.minibatch_size,
                             fused.minibatch_size)
    gathered_equal = bool(torch.equal(x, served.minibatch_data.devmem) and
                          torch.equal(labels, served.minibatch_labels.devmem))
    log("  the first gathered minibatch against the loader's own serve of "
        "the window: %s" % ("bitwise equal" if gathered_equal else "DIFFERS"))
    if not gathered_equal:
        raise AssertionError("the gathered minibatch differs from the "
                             "served one")
    del served, fused, x, labels
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        runs = {mode: _trajectory(torch, dev, 2, batch, mode)
                for mode in ("loader", "two-dispatch", "k")}
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    out = {}
    for name, (a, b) in (("loader step vs two-dispatch",
                          ("loader", "two-dispatch")),
                         ("K = %d vs %d x K = 1" % ((PIPE_PARITY_STEPS,) * 2),
                          ("k", "loader"))):
        (la, pa, va), (lb, pb, vb) = runs[a], runs[b]
        same = bool(torch.equal(la, lb)) and _bitwise_trees(torch, pa, pb) \
            and _bitwise_trees(torch, va, vb)
        log("  trajectory %s over %d steps, deterministic cuDNN: %s "
            "(losses %s)" % (name, PIPE_PARITY_STEPS,
                             "bitwise equal" if same else "DIFFER",
                             ", ".join("%.4f" % v for v in la.tolist())))
        if not same:
            raise AssertionError("trajectory %s differs: %s vs %s"
                                 % (name, la.tolist(), lb.tolist()))
        out[name] = dict(bitwise=same, losses=la.tolist())
    out["gathered_bitwise"] = gathered_equal
    return out


def _pipeline_units(torch):
    """MeanDispNormalizer and InputJoiner on Device() against the same
    units on Device(backend="cpu"), f32, bitwise."""
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.input_joiner import InputJoiner
    from veles_tpu_torch.mean_disp_normalizer import MeanDispNormalizer
    from veles_tpu_torch.memory import Array

    rng = np.random.default_rng(6)
    rows = PIPE_UNIT_ROWS
    dataset = rng.integers(0, 256, (4 * rows,) + PIPE_IMAGE).astype(
        np.float32)
    extra = rng.standard_normal((rows, 1000)).astype(np.float32)
    out = []
    for device in (Device(), Device(backend="cpu")):
        wf = AcceleratedWorkflow(None, name="pipeline-units")
        norm = MeanDispNormalizer.from_dataset(wf, dataset)
        norm.input = Array(dataset[:rows])
        norm.input.initialize(device)
        joiner = InputJoiner(wf, num_inputs=2)
        joiner.input_0 = norm.output
        joiner.input_1 = Array(extra)
        joiner.input_1.initialize(device)
        if norm.initialize(device=device) is not None or \
                joiner.initialize(device=device) is not None:
            raise AssertionError("a unit did not initialize")
        norm.run()
        joiner.run()
        out.append((np.array(norm.output.map_read()),
                    np.array(joiner.output.map_read()),
                    str(joiner.output.devmem.device)))
    (nc, jc, where), (np_, jp, _) = out
    ok = bool(np.array_equal(nc, np_) and np.array_equal(jc, jp))
    log("  MeanDispNormalizer [%d, %s] and InputJoiner -> %s on %s against "
        "Device(backend='cpu'), f32: %s" % (
            rows, ", ".join(map(str, PIPE_IMAGE)), jc.shape, where,
            "bitwise equal" if ok else "DIFFER"))
    if not ok or jc.shape != (rows, int(np.prod(PIPE_IMAGE)) + 1000):
        raise AssertionError("card and CPU units differ")
    return dict(bitwise=ok, joined_shape=list(jc.shape))


def pipeline_phase(torch, counters, dev, card):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader import PrefetchingServer

    b = CLASSIFIER_BATCH
    log("phase 16: the flagship's input pipeline: AlexNet (1000 classes, "
        "%s, seed 0), batch %d, bf16, %s; uint8 synthetic images, 2 x %d "
        "a loader, range_linear; %d interleaved windows of %d steps a leg, "
        "K = %d, prefetch depth %d" % (" x ".join(map(str, PIPE_IMAGE)), b,
                                       CLASSIFIER_HYPER, b, PIPE_WINDOWS,
                                       PIPE_STEPS, PIPE_K, PIPE_DEPTH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    trainer, fwd_flops = _pipe_trainer(dev)
    data = np.random.default_rng(1)              # bench.py:85-88
    xd = torch.from_numpy(data.random((b,) + PIPE_IMAGE,
                                      dtype=np.float32)).to(dev)
    ld = torch.from_numpy(data.integers(0, 1000, b)).to(dev)
    pipe_loader = _synth_images(b, 2, Device())
    fused_loader = _synth_images(b, 3, Device())
    ring_loader = _synth_images(b, 3, Device())
    if pipe_loader.device.torch_device.type != dev.type:
        raise AssertionError("the loader is on %s"
                             % pipe_loader.device.torch_device)
    dataset_bytes = pipe_loader._dataset_dev_.numel()
    pipe_step = trainer.make_loader_step(pipe_loader)
    fused_k = trainer.make_loader_step(fused_loader,
                                       steps_per_dispatch=PIPE_K)
    server = PrefetchingServer(
        ring_loader, depth=PIPE_DEPTH,
        transform=lambda d: d.to(trainer.compute_dtype)).start()

    def resident():
        return trainer.step(xd, ld)

    def pipeline():
        pipe_loader.run()
        return pipe_step()

    def prefetched():
        batches = server.get_many(PIPE_K, timeout=300)
        return trainer.step_many([bt.data for bt in batches],
                                 [bt.labels for bt in batches])

    dispatches = {"resident": (resident, 1), "pipeline": (pipeline, 1),
                  "overlap-fused": (fused_k, PIPE_K),
                  "overlap-prefetch": (prefetched, PIPE_K)}
    try:
        for fn, _ in dispatches.values():          # warm every leg
            fn()
        torch.cuda.synchronize()
        staged = server.get(timeout=300)
        ring_bytes = PIPE_DEPTH * staged.data.numel() * \
            staged.data.element_size()
        del staged
        setup_s = time.monotonic() - t0
        one = {}
        for name in ("pipeline", "overlap-fused"):
            fn, k = dispatches[name]
            before = counters.read()
            fn()
            torch.cuda.synchronize()
            one[name] = {kk: v for kk, v in counters.delta(before).items()
                         if v}
        expect = {"pipeline": {"lrn_fwd": 2, "lrn_bwd": 2,
                               "uniform_fill": 2},
                  "overlap-fused": {"lrn_fwd": 2 * PIPE_K,
                                    "lrn_bwd": 2 * PIPE_K,
                                    "uniform_fill": 2 * PIPE_K}}
        log("  launches around one K = 1 loader step: %s; around one K = %d "
            "dispatch: %s (need exactly %s and %s)" % (
                one["pipeline"], PIPE_K, one["overlap-fused"],
                expect["pipeline"], expect["overlap-fused"]))
        if one != expect:
            raise AssertionError("loader-step launches %s != %s"
                                 % (one, expect))

        times = {name: [] for name in PIPE_LEGS}
        walls = {name: [] for name in PIPE_LEGS}
        last = {}
        counters.reset()
        for _ in range(PIPE_WINDOWS):
            for name in PIPE_LEGS:
                fn, k = dispatches[name]
                ms, per_step, last[name] = _leg_window(
                    torch, fn, max(1, PIPE_STEPS // k), k)
                times[name].append(ms)
                walls[name].extend(per_step)
        launches = counters.read()
        profiles = {}
        for name, n in (("resident", PIPE_K), ("pipeline", PIPE_K),
                        ("overlap-fused", 1)):
            fn, _ = dispatches[name]

            def window(fn=fn, n=n):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()

            profiles[name] = profile_device(torch, window, 1,
                                            host_ops=False)
    finally:
        server.stop()
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("prefetch")]
    log("  threads left after PrefetchingServer.stop(): %s" % (leaked or
                                                               "none"))
    if leaked:
        raise AssertionError("prefetch threads left: %s" % leaked)
    peak = torch.cuda.max_memory_allocated()
    gather_ms = device_ms(lambda: pipe_loader.gather(0, b), 3)
    window = pipe_loader._window(0, b)
    rows = pipe_loader._dataset_dev_.index_select(0, window)
    index_ms = device_ms(
        lambda: pipe_loader._dataset_dev_.index_select(0, window), 3)
    normalize_ms = device_ms(lambda: pipe_loader.normalizer.apply_torch(
        rows, pipe_loader._stats_dev_), 3)
    del window, rows

    legs = {}
    for name in PIPE_LEGS:
        best, mean = min(times[name]), float(np.mean(times[name]))
        st = dict(p50=float(np.percentile(walls[name], 50)),
                  p99=float(np.percentile(walls[name], 99)),
                  max=float(np.max(walls[name])))
        legs[name] = dict(ms_per_step=times[name], best_ms=best,
                          mean_ms=mean, images_per_s_best=b * 1e3 / best,
                          images_per_s_mean=b * 1e3 / mean,
                          wall_ms=st, steps=len(walls[name]))
        log("  %s: %.1f images/s at the best window (%.3f ms a step), %.1f "
            "at the mean (%.3f ms); per-step wall p50 %.3f, p99 %.3f, max "
            "%.3f ms over %d steps [%s]" % (
                name, b * 1e3 / best, best, b * 1e3 / mean, mean, st["p50"],
                st["p99"], st["max"], len(walls[name]), card))
    res = legs["resident"]["images_per_s_best"]
    ratios = dict(
        pipeline_vs_resident=legs["pipeline"]["images_per_s_best"] / res,
        loader_overlap_efficiency_fused=(
            legs["overlap-fused"]["images_per_s_best"] / res),
        loader_overlap_efficiency_prefetch=(
            legs["overlap-prefetch"]["images_per_s_best"] / res))
    log("  pipeline_vs_resident %.4f; loader_overlap_efficiency: fused "
        "%.4f, prefetch %.4f (best windows; at the means %.4f, %.4f, %.4f)"
        % (ratios["pipeline_vs_resident"],
           ratios["loader_overlap_efficiency_fused"],
           ratios["loader_overlap_efficiency_prefetch"],
           legs["pipeline"]["images_per_s_mean"] /
           legs["resident"]["images_per_s_mean"],
           legs["overlap-fused"]["images_per_s_mean"] /
           legs["resident"]["images_per_s_mean"],
           legs["overlap-prefetch"]["images_per_s_mean"] /
           legs["resident"]["images_per_s_mean"]))
    for name, prof in profiles.items():
        if prof is None:
            log("  profile %s window: no device time recorded" % name)
            continue
        log("  profile %s window (%d steps): wall %.3f ms, device %.3f ms "
            "(busy %.0f%%); by class: %s" % (
                name, PIPE_K, prof["wall_ms"], prof["device_ms"],
                100 * prof["busy_share"], "; ".join(
                    "%s %.3f" % kv for kv in sorted(
                        prof["by_class"].items(), key=lambda kv: -kv[1]))))
    log("  gather + normalize of one minibatch (uint8 [%d, %s] -> f32): "
        "device %.3f ms (the index_select %.3f, the normalizer %.3f); the "
        "dataset on the card %.1f MB a loader; the "
        "prefetch ring %d x %.1f MB = %.1f MB staged (bf16); peak memory "
        "%.2f GB; set-up %.1f s [%s]" % (
            b, ", ".join(map(str, PIPE_IMAGE)), gather_ms, index_ms,
            normalize_ms, dataset_bytes / 1e6,
            PIPE_DEPTH, ring_bytes / PIPE_DEPTH / 1e6, ring_bytes / 1e6,
            peak / 1e9, setup_s, card))
    losses = {name: m["loss"].reshape(-1).tolist()
              for name, m in last.items()}
    log("  last losses: %s" % "; ".join(
        "%s %s" % (name, ", ".join("%.4f" % v for v in ls))
        for name, ls in losses.items()))
    if not all(np.isfinite(v) for ls in losses.values() for v in ls) or \
            trainer.nonfinite_count:
        raise AssertionError("non-finite pipeline losses: %s" % losses)
    del trainer, xd, ld, pipe_loader, fused_loader, ring_loader, server
    del dispatches, pipe_step, fused_k, last
    gc.collect()
    parity = _pipeline_parity(torch, dev, b)
    units = _pipeline_units(torch)
    return dict(batch=b, hyper=CLASSIFIER_HYPER, windows=PIPE_WINDOWS,
                steps_per_window=PIPE_STEPS, k=PIPE_K, depth=PIPE_DEPTH,
                setup_s=setup_s, legs=legs, ratios=ratios,
                launches_one=one, profiles=profiles,
                gather_normalize_ms=gather_ms, index_select_ms=index_ms,
                normalize_ms=normalize_ms, dataset_bytes=dataset_bytes,
                ring_bytes=ring_bytes, peak_mem_bytes=peak,
                fwd_flops_per_image=fwd_flops, losses=losses,
                parity=parity, units=units), launches


# ---------------------------------------------------------------------------
# phase 17: the four unit families and the model zoo on Device()
# ---------------------------------------------------------------------------

#: phase 17: every model at its own widths, f32 params and bf16 compute,
#: one epoch from ZOO_SEED; STL-10's synthetic dataset is cut to these
#: many images (96 x 96 x 3 kept), the others run at their loaders'
#: defaults (digits 6,000 TRAIN / 1,000 VALID, colour images 5,000 /
#: 1,000)
ZOO_SEED = 42
ZOO_STL10_DATA = dict(n_train=1000, n_valid=200)
#: the row-wise LSTM classifier: 28 steps of 28 pixels
ZOO_LSTM_LAYERS = [{"type": "lstm", "hidden": 128},
                   {"type": "softmax", "output_sample_shape": 10}]
#: RBM and SOM: minibatches of 100 rows of the digits' TRAIN set (784
#: visible units), 60 steps each
ZOO_ROWS = 100
ZOO_STEPS = 60
ZOO_RBM_HIDDEN = 500
#: K8 launches of one TRAIN minibatch (its dropout layers; 0 elsewhere
#: and on every VALID minibatch) and of one CD-1 step
ZOO_K8_TRAIN = {"vgg16": 2, "stl10": 1}
ZOO_K8_CD1 = 1
#: TRAIN minibatches under the profiler, served and run unit by unit
ZOO_PROFILED = 3
#: the shapes K8 fills on this path: VGG-16's two dropout masks, STL-10's
#: one, the RBM's hidden sample
ZOO_FILL_SHAPES = ((50, 4096), (50, 128), (ZOO_ROWS, ZOO_RBM_HIDDEN))
#: phase 18: reduced sample counts (the widths kept), f32
ZOO_PARITY_DATA = dict(n_train=600, n_valid=200)
#: phase 18 bounds, as shares of each value's scale: f32 on the card
#: against f32 on the CPU differs in the order of sums only (phase 15's
#: bound); the RBM's one step is held to 1e-5, its only sums are 100-
#: and 784-term products
TOL_ZOO = 1e-4
TOL_RBM = 1e-5


def _zoo_models():
    from veles_tpu_torch.models.autoencoder import (AutoencoderWorkflow,
                                                    ConvAutoencoderWorkflow)
    from veles_tpu_torch.models.cifar import CifarWorkflow
    from veles_tpu_torch.models.lenet import LenetWorkflow
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.models.stl10 import Stl10Workflow
    from veles_tpu_torch.models.vgg import VggWorkflow

    return [
        ("vgg16", lambda: VggWorkflow(depth=16, max_epochs=1)),
        ("conv_autoencoder", lambda: ConvAutoencoderWorkflow(max_epochs=1)),
        ("autoencoder", lambda: AutoencoderWorkflow(max_epochs=1)),
        ("lstm", lambda: StandardWorkflow(layers=ZOO_LSTM_LAYERS,
                                          max_epochs=1)),
        ("lenet", lambda: LenetWorkflow(max_epochs=1)),
        ("cifar", lambda: CifarWorkflow(max_epochs=1)),
        ("stl10", lambda: Stl10Workflow(
            max_epochs=1, loader_kwargs=dict(ZOO_STL10_DATA)))]


def _zoo_hooks(wf, counters, records, metrics):
    """Record, at the start of every minibatch (the loader's run), the
    host clock and the launch counters; after the evaluator, the
    minibatch's (class, errors, loss, size): n_err and the summed loss
    of a classifier, the summed RMSE and squared error of an
    autoencoder."""
    loader, evaluator = wf.loader, wf.evaluator
    serve, evaluate = loader.run, evaluator.run

    def serving():
        records.append((time.perf_counter(), counters.read()))
        serve()
        records[-1] += (loader.minibatch_class,)

    def evaluating():
        evaluate()
        if hasattr(evaluator, "sum_rmse"):
            metrics.append((loader.minibatch_class, evaluator.sum_rmse,
                            evaluator.sum_sq, loader.minibatch_size))
        else:
            metrics.append((loader.minibatch_class, evaluator.n_err,
                            evaluator.loss, loader.minibatch_size))

    loader.run = serving
    evaluator.run = evaluating


def _zoo_train_minibatch(torch, wf):
    """Serve minibatches until a TRAIN one, then run its units in the
    graph's order, ending synchronized."""
    wf.loader.run()
    while wf.loader.minibatch_class != 2:
        wf.loader.run()
    for unit in wf.forwards:
        unit.run()
    wf.evaluator.run()
    wf.decision.run()
    for gd in wf.gds:
        gd.run()
    torch.cuda.synchronize()


def _fmt_classes(prof):
    if prof is None:
        return "no device time recorded"
    return "%.3f ms device, busy %.2f; %s" % (
        prof["device_ms"], prof["busy_share"], "; ".join(
            "%s %.3f" % kv for kv in sorted(prof["by_class"].items(),
                                            key=lambda kv: -kv[1])))


def _zoo_workflow(torch, counters, card, name, make):
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import CudaDevice, Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.standard import params_of

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    root.common.random.seed = ZOO_SEED
    prng.reset()
    t0 = time.monotonic()
    device = Device()
    if not isinstance(device, CudaDevice):
        raise AssertionError("Device() is %r, not the card" % (device,))
    wf = make()
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    n_params = int(sum(a.size for p in params_of(wf) for a in p.values()))
    mbs = wf.loader.max_minibatch_size
    records, metrics = [], []
    _zoo_hooks(wf, counters, records, metrics)
    t0 = time.monotonic()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    records.append((time.perf_counter(), counters.read(), None))
    per_mb = []
    for (t_a, c_a, klass), (t_b, c_b, _) in zip(records, records[1:]):
        per_mb.append(dict(klass=klass, ms=(t_b - t_a) * 1e3, launches={
            k: c_b[k] - c_a[k] for k in c_b if c_b[k] != c_a[k]}))
    k8 = ZOO_K8_TRAIN.get(name, 0)
    for i, mb in enumerate(per_mb):
        want = {"uniform_fill": k8} if mb["klass"] == 2 and k8 else {}
        if mb["launches"] != want:
            raise AssertionError("%s: minibatch %d (class %d) launched %s, "
                                 "not %s" % (name, i, mb["klass"],
                                             mb["launches"], want))
    train_ms = [mb["ms"] for mb in per_mb if mb["klass"] == 2]
    valid_ms = [mb["ms"] for mb in per_mb if mb["klass"] == 1]
    train = dict(p50=float(np.percentile(train_ms, 50)),
                 p99=float(np.percentile(train_ms, 99)))
    valid = dict(p50=float(np.percentile(valid_ms, 50)),
                 p99=float(np.percentile(valid_ms, 99)))
    losses = [m[2] / m[3] for m in metrics if m[0] == 2]
    errors = {k: list(v) for k, v in wf.decision.epoch_errors.items()}
    if not (all(np.isfinite(losses)) and
            all(np.isfinite(v) for vs in errors.values() for v in vs)):
        raise AssertionError("%s: non-finite losses or errors: %s %s"
                             % (name, losses, errors))
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if name == "vgg16" and not tail < head:
        raise AssertionError("vgg16: the TRAIN losses did not fall: "
                             "first 10 %.5f, last 10 %.5f" % (head, tail))
    if not bool(wf.decision.complete):
        raise AssertionError("%s: the decision did not complete" % name)
    peak = torch.cuda.max_memory_allocated()
    wf.resume_overrides(max_epochs=2)
    prof = profile_device(torch, lambda: _zoo_train_minibatch(torch, wf),
                          ZOO_PROFILED, host_ops=False)
    kind = "MSE" if hasattr(wf.evaluator, "sum_rmse") else "n_err"
    log("  %s: %s parameters, minibatch %d, %d TRAIN + %d VALID "
        "minibatches in %.2f s (set-up %.1f s); ms a minibatch TRAIN p50 "
        "%.3f p99 %.3f, VALID p50 %.3f p99 %.3f; %.1f images/s training "
        "at the p50; K8 %d a TRAIN minibatch, 0 a VALID one; peak %.2f GB"
        % (name, format(n_params, ","), mbs, len(train_ms), len(valid_ms),
           run_s, setup_s, train["p50"], train["p99"], valid["p50"],
           valid["p99"], mbs * 1e3 / train["p50"], k8, peak / 1e9))
    log("    one TRAIN minibatch on the device (%d profiled): %s"
        % (ZOO_PROFILED, _fmt_classes(prof)))
    log("    %s by epoch: VALID %s, TRAIN %s; TRAIN %s a sample: first "
        "%.5f, last %.5f (mean of the first 10 %.5f, last 10 %.5f) [%s]"
        % ("RMSE" if kind == "MSE" else "errors %", errors.get(1),
           errors.get(2), "squared error" if kind == "MSE" else "loss",
           losses[0], losses[-1], head, tail, card))
    wf.thread_pool.shutdown()
    del wf
    return dict(parameters=n_params, minibatch=mbs, setup_s=setup_s,
                run_s=run_s, train_ms=train, valid_ms=valid,
                images_per_s=mbs * 1e3 / train["p50"],
                train_minibatches=len(train_ms),
                valid_minibatches=len(valid_ms), k8_train=k8,
                epoch_errors=errors, first_loss=losses[0],
                last_loss=losses[-1], head_loss=head, tail_loss=tail,
                peak_mem_bytes=peak, profile=prof)


def _digit_rows(device):
    """The digits' TRAIN set on ``device`` as [n, 784] f32 rows (the
    SyntheticDigitsLoader's own data at its defaults, ZOO_SEED)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader.datasets import SyntheticDigitsLoader

    root.common.random.seed = ZOO_SEED
    prng.reset()
    wf = AcceleratedWorkflow(None, name="digits")
    loader = SyntheticDigitsLoader(wf, minibatch_size=ZOO_ROWS)
    loader.initialize(device=device)
    start = loader.class_lengths[0] + loader.class_lengths[1]
    rows = np.asarray(loader.original_data[start:], np.float32)
    return rows.reshape(len(rows), -1)


def _unsupervised_pair(device, rows, kind):
    """(forward unit, trainer) of ``kind`` ("rbm" or "som") over the
    first minibatch of ``rows`` (a tensor on ``device``), from fresh
    streams of ZOO_SEED."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.config import root
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn import (RBM, KohonenForward, KohonenTrainer,
                                    RBMTrainer)

    root.common.random.seed = ZOO_SEED
    prng.reset()
    wf = AcceleratedWorkflow(None, name=kind)
    fwd = RBM(wf, n_hidden=ZOO_RBM_HIDDEN) if kind == "rbm" \
        else KohonenForward(wf)
    fwd.input = Array(np.asarray(rows[:ZOO_ROWS].cpu()))
    fwd.input.initialize(device)
    if fwd.initialize(device=device) is not None:
        raise AssertionError("%s did not initialize" % kind)
    if kind == "rbm":
        trainer = RBMTrainer(wf)
        trainer.link_attrs(fwd, "input", "weights", "vbias", "hbias")
    else:
        trainer = KohonenTrainer(wf)
        trainer.link_attrs(fwd, "input", "codebook")
        trainer.grid = fwd.grid_positions
    trainer.batch_size = ZOO_ROWS
    if trainer.initialize(device=device) is not None:
        raise AssertionError("the %s trainer did not initialize" % kind)
    return fwd, trainer


def _zoo_unsupervised(torch, counters, card, dev, kind):
    from veles_tpu_torch.backends import Device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = torch.from_numpy(_digit_rows(Device())).to(dev)
    fwd, trainer = _unsupervised_pair(Device(), rows, kind)
    want = {"uniform_fill": ZOO_K8_CD1} if kind == "rbm" else {}

    def step(i):
        fwd.input.devmem = rows[(i % (len(rows) // ZOO_ROWS)) * ZOO_ROWS:][
            :ZOO_ROWS]
        trainer.run()     # ends on its one host read of the error
        return trainer.recon_err if kind == "rbm" \
            else trainer.avg_quantization_err

    errs, ms = [], []
    for i in range(ZOO_STEPS):
        before = counters.read()
        t0 = time.perf_counter()
        errs.append(step(i))
        ms.append((time.perf_counter() - t0) * 1e3)
        delta = {k: v for k, v in counters.delta(before).items() if v}
        if delta != want:
            raise AssertionError("%s step %d launched %s, not %s"
                                 % (kind, i, delta, want))
    head, tail = float(np.mean(errs[:10])), float(np.mean(errs[-10:]))
    if not all(np.isfinite(errs)) or not tail < head:
        raise AssertionError("%s: the error did not fall: first 10 %.5f, "
                             "last 10 %.5f" % (kind, head, tail))
    steps = iter(range(ZOO_STEPS, 10 ** 6))
    prof = profile_device(torch, lambda: (step(next(steps)),
                                          torch.cuda.synchronize()),
                          ZOO_PROFILED, host_ops=False)
    stats = dict(p50=float(np.percentile(ms, 50)),
                 p99=float(np.percentile(ms, 99)))
    peak = torch.cuda.max_memory_allocated()
    what = "CD-1 step" if kind == "rbm" else "SOM step"
    log("  %s (%s): %d %ss of %d rows, ms a step p50 %.3f p99 %.3f (%.1f "
        "steps/s); K8 %d a step; peak %.2f GB; %s a step: first %.4f, "
        "last %.4f (mean of the first 10 %.4f, last 10 %.4f) [%s]" % (
            kind, "n_hidden %d" % ZOO_RBM_HIDDEN if kind == "rbm"
            else "8 x 8 map", ZOO_STEPS, what, ZOO_ROWS, stats["p50"],
            stats["p99"], 1e3 / stats["p50"], len(want) and ZOO_K8_CD1,
            peak / 1e9, "reconstruction error" if kind == "rbm"
            else "quantization error", errs[0], errs[-1], head, tail, card))
    log("    one %s on the device: %s" % (what, _fmt_classes(prof)))
    del fwd, trainer, rows
    return dict(step_ms=stats, steps_per_s=1e3 / stats["p50"],
                errors=errs, head=head, tail=tail, peak_mem_bytes=peak,
                profile=prof)


def zoo_phase(torch, counters, dev, card):
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import rng

    log("phase 17: the unit families and the model zoo on Device(), f32 "
        "params, %s compute, one epoch each from seed %d; STL-10's "
        "dataset cut to %s (96 x 96 x 3 kept); RBM and SOM over %d "
        "minibatches of %d digit rows" % (
            root.common.engine.compute_type, ZOO_SEED, ZOO_STL10_DATA,
            ZOO_STEPS, ZOO_ROWS))
    # K8 at this path's shapes against its plain version (comparison
    # launches, before the path's counts start)
    for shape in ZOO_FILL_SHAPES:
        a = rng.uniform_fill(ZOO_SEED, shape, device=dev, impl="cuda")
        b = rng.uniform_fill(ZOO_SEED, shape, device=dev, impl="plain")
        if not bool(torch.equal(a, b)):
            raise AssertionError("uniform_fill %s: kernel != plain"
                                 % (shape,))
    log("  uniform_fill at %s: kernel == plain bitwise"
        % ", ".join(str(list(s)) for s in ZOO_FILL_SHAPES))
    counters.reset()
    out = {}
    for name, make in _zoo_models():
        out[name] = _zoo_workflow(torch, counters, card, name, make)
    for kind in ("rbm", "som"):
        out[kind] = _zoo_unsupervised(torch, counters, card, dev, kind)
    launches = counters.read()
    log("  launches over the phase: %s" % {k: v for k, v in
                                            launches.items() if v})
    return out, launches


# ---------------------------------------------------------------------------
# phase 18: the unit families and the zoo, card against CPU at f32
# ---------------------------------------------------------------------------

def _zoo_parity_run(device, name):
    """One epoch of the conv autoencoder or the LSTM classifier at
    ZOO_PARITY_DATA on ``device`` from ZOO_SEED: every minibatch's
    (class, errors, loss), the errors by epoch and params_of."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.autoencoder import ConvAutoencoderWorkflow
    from veles_tpu_torch.models.standard import StandardWorkflow, params_of

    root.common.random.seed = ZOO_SEED
    prng.reset()
    if name == "conv_autoencoder":
        wf = ConvAutoencoderWorkflow(max_epochs=1,
                                     loader_kwargs=dict(ZOO_PARITY_DATA))
    else:
        wf = StandardWorkflow(layers=ZOO_LSTM_LAYERS, max_epochs=1,
                              loader_kwargs=dict(ZOO_PARITY_DATA))
    wf.initialize(device=device)
    metrics = []
    _zoo_hooks(wf, Counters(), [], metrics)
    wf.run()
    errors = {k: list(v) for k, v in wf.decision.epoch_errors.items()}
    params = params_of(wf)
    wf.thread_pool.shutdown()
    return metrics, errors, params


def _share(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _decoder_pair(torch, device, x, err):
    """A Deconv (the conv autoencoder's decoder layer) with two GDDeconv
    steps, and Depooling with GDDepooling, on ``device``."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.config import root
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn import Deconv, Depooling, gd_for

    root.common.random.seed = ZOO_SEED
    prng.reset()
    wf = AcceleratedWorkflow(None, name="decoder")

    def array(data):
        arr = Array(data)
        arr.initialize(device)
        return arr

    fwd = Deconv(wf, n_kernels=1, kx=3, sliding=(2, 2),
                 weights_filling="gaussian", weights_stddev=0.02)
    fwd.input = array(x)
    fwd.initialize(device=device)
    fwd.run()
    out = np.array(fwd.output.map_read())
    gd = gd_for(fwd, wf, learning_rate=3e-4, momentum=0.9)
    gd.err_output = array(err)
    gd.initialize(device=device)
    for _ in range(2):
        gd.run()
    depool = Depooling(wf, kx=2)
    depool.input = array(x)
    depool.initialize(device=device)
    depool.run()
    gdp = gd_for(depool, wf)
    gdp.err_output = depool.output
    gdp.initialize(device=device)
    gdp.run()
    return dict(out=out, err_input=np.array(gd.err_input.map_read()),
                weights=np.array(gd.weights.map_read()),
                bias=np.array(gd.bias.map_read()),
                velocity=np.array(gd.velocity_weights.map_read()),
                depool=np.array(depool.output.map_read()),
                undepool=np.array(gdp.err_input.map_read()))


def _rbm_once(torch, device, rows):
    fwd, trainer = _unsupervised_pair(device, rows, "rbm")
    fwd.run()
    h0p = np.array(fwd.output.map_read())
    fills = []
    uniform = trainer.rand.uniform

    def recording(*a, **k):
        fills.append(uniform(*a, **k))
        return fills[-1]

    trainer.rand.uniform = recording
    trainer.run()
    return dict(fill=fills[0].cpu().numpy(), h0p=h0p,
                err=trainer.recon_err,
                **{a: np.array(getattr(fwd, a).map_read())
                   for a in ("weights", "vbias", "hbias")})


def _som_steps(device, rows, steps=3):
    fwd, trainer = _unsupervised_pair(device, rows, "som")
    winners = []
    for i in range(steps):
        fwd.input.devmem = rows[i * ZOO_ROWS:(i + 1) * ZOO_ROWS]
        trainer.run()
        winners.append(trainer.winners.cpu().numpy())
    return winners, np.array(fwd.codebook.map_read())


def zoo_parity_phase(torch, dev, card):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root

    log("phase 18: the unit families and the zoo, Device() against "
        "Device(backend='cpu') at f32 from seed %d: the conv autoencoder "
        "and the LSTM classifier (%s, widths kept), one epoch; a CD-1 "
        "step; SOM winners; the decoder units" % (ZOO_SEED,
                                                  ZOO_PARITY_DATA))
    saved = root.common.engine.compute_type
    root.common.engine.compute_type = "float32"
    out = {}
    try:
        for name in ("conv_autoencoder", "lstm"):
            t0 = time.monotonic()
            card_run = _zoo_parity_run(Device(), name)
            card_s = time.monotonic() - t0
            t0 = time.monotonic()
            cpu_run = _zoo_parity_run(Device(backend="cpu"), name)
            cpu_s = time.monotonic() - t0
            (mk, ek, pk), (mp, ep, pp) = card_run, cpu_run
            exact = 1 if name == "lstm" else 0   # n_err, or a float RMSE
            if [m[:1 + exact] for m in mk] != [m[:1 + exact] for m in mp]:
                raise AssertionError("%s: classes / errors per minibatch "
                                     "differ" % name)
            metric_err = max(_share(a[1:3], b[1:3]) for a, b in zip(mk, mp))
            epoch_err = max(_share(ek[k], ep[k]) for k in ep if ep[k])
            param_err = max(_share(a[key], b[key])
                            for a, b in zip(pk, pp) for key in b)
            log("  %s: %d minibatches, card %.1f s, CPU %.1f s; errors by "
                "epoch card %s, CPU %s" % (name, len(mk), card_s, cpu_s,
                                           ek, ep))
            check("%s per-minibatch metric and loss" % name, metric_err,
                  TOL_ZOO)
            check("%s errors by epoch" % name, epoch_err, TOL_ZOO)
            check("%s params_of after the epoch" % name, param_err,
                  TOL_ZOO)
            out[name] = dict(minibatches=len(mk), metric_rel_err=metric_err,
                             epoch_rel_err=epoch_err,
                             param_rel_err=param_err, card_s=card_s,
                             cpu_s=cpu_s, epoch_errors=ek)

        rows_host = _digit_rows(Device(backend="cpu"))[:3 * ZOO_ROWS]
        rows = {d: torch.from_numpy(rows_host).to(d.torch_device)
                for d in (Device(), Device(backend="cpu"))}
        card_rbm, cpu_rbm = (_rbm_once(torch, d, r) for d, r in rows.items())
        if not np.array_equal(card_rbm["fill"], cpu_rbm["fill"]):
            raise AssertionError("the RBM's K8 fill differs from the "
                                 "CPU's plain fill")
        near = int((np.abs(cpu_rbm["fill"] - cpu_rbm["h0p"]) <=
                    2 * max(_share(card_rbm["h0p"], cpu_rbm["h0p"]),
                            1e-7)).sum())
        rbm_err = max(_share(card_rbm[k], cpu_rbm[k])
                      for k in ("weights", "vbias", "hbias"))
        log("  RBM CD-1 step: K8 fill == plain fill bitwise %s; samples "
            "whose fill lies within rounding of h0p: %d; reconstruction "
            "error card %.6f, CPU %.6f" % (list(card_rbm["fill"].shape),
                                           near, card_rbm["err"],
                                           cpu_rbm["err"]))
        check("RBM update, card vs CPU (share of scale)", rbm_err, TOL_RBM)

        (wk, ck), (wp, cp) = (_som_steps(d, r) for d, r in rows.items())
        same = all(np.array_equal(a, b) for a, b in zip(wk, wp))
        log("  SOM: winners of %d steps equal: %s (%d distinct)"
            % (len(wk), same, len(np.unique(np.concatenate(wk)))))
        if not same:
            raise AssertionError("SOM winners differ between the card and "
                                 "the CPU")
        check("SOM codebook after 3 steps", _share(ck, cp), TOL_ZOO)

        rng = np.random.default_rng(ZOO_SEED)
        x = rng.standard_normal((ZOO_ROWS, 14, 14, 8)).astype(np.float32)
        err = (rng.standard_normal((ZOO_ROWS, 28, 28, 1)) * 0.1).astype(
            np.float32)
        dk, dp = (_decoder_pair(torch, d, x, err)
                  for d in (Device(), Device(backend="cpu")))
        for key in ("out", "err_input", "weights", "bias"):
            check("Deconv/GDDeconv %s" % key, _share(dk[key], dp[key]),
                  TOL_ZOO)
        # the weight gradient sums 100 x 28 x 28 products per weight:
        # cuDNN's and the CPU's orders differ (the units test's bound)
        check("GDDeconv velocity (weight gradient)",
              _share(dk["velocity"], dp["velocity"]), 10 * TOL_ZOO)
        for key in ("depool", "undepool"):
            if not np.array_equal(dk[key], dp[key]):
                raise AssertionError("%s differs between card and CPU"
                                     % key)
        if not np.array_equal(dk["undepool"], x):
            raise AssertionError("GDDepooling(Depooling(x)) != x")
        log("  Depooling and GDDepooling bitwise equal on the card and the "
            "CPU [%s]" % card)
        out.update(rbm=dict(rel_err=rbm_err, near_ties=near),
                   som=dict(steps=len(wk), winners_equal=same),
                   decoder={k: _share(dk[k], dp[k]) for k in
                            ("out", "err_input", "weights", "velocity")})
    finally:
        root.common.engine.compute_type = saved
    return out


# ---------------------------------------------------------------------------
# phase 19: the state half at full width
# ---------------------------------------------------------------------------

#: phase 19a: the LM of phase 5 (FULL, bf16, remat "attn", batch 8, lr
#: 1e-4) trained by TransformerWorkflow over SyntheticTextLoader for 3
#: epochs; 88 windows of seq_len + 1 tokens a corpus: 8 VALID windows
#: (valid_ratio 0.1, one minibatch) and 80 TRAIN (10 minibatches)
STATE_EPOCHS = 3
STATE_TOKENS = 88 * (FULL["seq_len"] + 1)
STATE_SEED = 7
#: launches of one captured LM TRAIN step (K1 twice a layer: forward
#: and the recompute of remat "attn"; K2, K3 once a layer), of one VALID
#: minibatch (the forward), and of one train_fused step (phase 14's
#: TRAIN minibatch)
STATE_LM_STEP = {"flash_fwd": 24, "flash_bwd_dkv": 12, "flash_bwd_dq": 12}
STATE_LM_VALID = {"flash_fwd": 12}
STATE_FUSED_STEP = {"lrn_fwd": 2, "lrn_bwd": 2, "uniform_fill": 2}
#: the JAX package's own bound on a resumed run's params
#: (tests/test_snapshot.py), held where they are not bitwise
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
#: the gzip level of the Snapshotter's "gz" codec (gzip.open's
#: default), and the slices of the snapshot it is timed over
GZIP_LEVEL = 9
GZIP_SAMPLES = 16
GZIP_SLICE = 16 << 20


def _nonzero(d):
    return {k: v for k, v in d.items() if v}


def _state_leaves(state):
    """The numpy leaves of a TransformerUnit._host_state() tree, in a
    fixed order (params, then Adam m and v)."""
    from veles_tpu_torch.models.transformer import _tree_leaves
    return [leaf for key in ("params", "opt_m", "opt_v")
            for leaf in _tree_leaves(state[key])]


def _lm_state_run(torch, counters, wf, steps, saves):
    """Run ``wf`` with every TransformerUnit run (its minibatch class, host
    wall ms, launches and loss) and every Snapshotter.save (guard ms,
    total ms) recorded. The hooks patch the classes, not the instances:
    an instance attribute would ride the snapshots."""
    from veles_tpu_torch.models.lm import TransformerUnit
    from veles_tpu_torch.snapshotter import Snapshotter
    run, save, guard = (TransformerUnit.run, Snapshotter.save,
                        Snapshotter.nonfinite_params)

    def timed_run(unit):
        before = counters.read()
        t0 = time.perf_counter()
        run(unit)                      # ends with float(loss): a sync
        steps.append((unit.minibatch_class, (time.perf_counter() - t0) * 1e3,
                      _nonzero(counters.delta(before)), unit.loss))

    def timed_guard(snap):
        t0 = time.perf_counter()
        bad = guard(snap)
        saves.append({"guard_ms": (time.perf_counter() - t0) * 1e3})
        return bad

    def timed_save(snap, force=False):
        t0 = time.perf_counter()
        path = save(snap, force)
        saves[-1].update(save_ms=(time.perf_counter() - t0) * 1e3,
                         path=path)
        return path

    TransformerUnit.run, Snapshotter.save = timed_run, timed_save
    Snapshotter.nonfinite_params = timed_guard
    try:
        t0 = time.monotonic()
        wf.run()
        torch.cuda.synchronize()
        return time.monotonic() - t0
    finally:
        TransformerUnit.run, Snapshotter.save = run, save
        Snapshotter.nonfinite_params = guard


def _check_lm_steps(label, steps):
    """Every TRAIN step but a trainer's first (whose capture runs the
    step twice more) launches STATE_LM_STEP; every VALID minibatch
    STATE_LM_VALID. Returns the TRAIN steps' host ms (the first
    excluded)."""
    train = [s for s in steps if s[0] == 2]
    for klass, _, launches, _ in steps:
        want = STATE_LM_STEP if klass == 2 else STATE_LM_VALID
        if klass == 2 and launches is train[0][2]:
            continue
        if launches != want:
            raise AssertionError("%s: a %s minibatch launched %s, not %s"
                                 % (label, "TRAIN" if klass == 2
                                    else "VALID", launches, want))
    return [s[1] for s in train[1:]]


def _load_in_cpu_process(path):
    """Load a snapshot in a fresh process that sees no card: its trainer
    state's step count and the f64 sum of its embedding."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, %r)\n"
        "import torch\n"
        "from veles_tpu_torch.snapshotter import Snapshotter\n"
        "wf = Snapshotter.load(%r)\n"
        "s = wf.trainer_unit._saved_state\n"
        "print(json.dumps({'cuda': torch.cuda.is_available(),\n"
        "    'step_count': s['step_count'],\n"
        "    'embed_sum': float(s['params']['embed'].sum(dtype='f8')),\n"
        "    'epoch': wf.decision.epoch_number}))\n" % (HERE, path))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=HERE,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    if out.returncode:
        raise AssertionError("loading %s without a card failed: %s"
                             % (path, out.stderr[-2000:]))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    got["seconds"] = time.monotonic() - t0
    return got


def _epoch2_manifest(store):
    """The manifest of the newest generation saved at epoch 2 (its meta's
    suffix), read from the manifests alone."""
    found = None
    for gen in store.generations():
        with open(store._manifest_path(gen)) as f:
            if json.load(f)["meta"]["suffix"].split("_")[0] == "2":
                found = store._manifest_path(gen)
    if found is None:
        raise AssertionError("no epoch-2 generation in %s"
                             % store.generations())
    return found


def state_lm_phase(torch, counters, card, train):
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.lm import TransformerWorkflow
    from veles_tpu_torch.models.transformer import TransformerConfig
    from veles_tpu_torch.snapshotter import Snapshotter

    config = TransformerConfig(compute="bfloat16", remat="attn", **FULL)
    log("phase 19a: TransformerWorkflow at full width (%s), batch %d, lr "
        "%g, SyntheticTextLoader of %d tokens (10 TRAIN and 1 VALID "
        "minibatch an epoch), Snapshotter(sharded=True), %d epochs (run A)"
        "; run B resumes from the epoch-2 manifest"
        % (config, TRAIN_BATCH, TRAIN_LR, STATE_TOKENS, STATE_EPOCHS))
    snapdir = os.path.join(HERE, "chip_smoke_out", "state_lm")
    shutil.rmtree(snapdir, ignore_errors=True)

    def make():
        return TransformerWorkflow(
            config=config, learning_rate=TRAIN_LR, max_epochs=STATE_EPOCHS,
            fail_iterations=100, snapshot_dir=snapdir, snapshot_prefix="lm",
            loader_kwargs=dict(minibatch_size=TRAIN_BATCH,
                               n_tokens=STATE_TOKENS))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    root.common.random.seed = STATE_SEED
    prng.reset()
    wf = make()
    wf.snapshotter.sharded = True
    t0 = time.monotonic()
    wf.initialize(device=Device())
    setup_s = time.monotonic() - t0
    steps_a, saves = [], []
    run_a_s = _lm_state_run(torch, counters, wf, steps_a, saves)
    ck = wf.snapshotter.checkpointer
    if not ck.wait(timeout=900):
        raise AssertionError("the checkpoint writer did not finish")
    stats = ck.stats()
    if stats["failures"] or stats["saves_committed"] != len(saves):
        raise AssertionError("checkpoints: %s for %d saves"
                             % (stats, len(saves)))
    peak = torch.cuda.max_memory_allocated()
    train_ms = _check_lm_steps("run A", steps_a)
    step_p50 = float(np.percentile(train_ms, 50))
    losses = [s[3] for s in steps_a if s[0] == 2]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("run A losses: %s" % losses)
    final_a = wf.trainer_unit._host_state()
    errors_a = {k: list(v) for k, v in wf.decision.epoch_errors.items()}
    manifest = _epoch2_manifest(ck.store)
    per_save = dict(
        guard_ms=[s["guard_ms"] for s in saves],
        save_ms=[s["save_ms"] for s in saves],
        stall_ms=stats["stall_seconds"] * 1e3 / len(saves),
        writer_ms=stats["save_seconds"] * 1e3 / len(saves),
        bytes=stats["bytes_written"] / len(saves))
    log("  run A: set-up %.1f s, run %.1f s; %d TRAIN steps, ms per TRAIN "
        "step (host wall, its loss read included; the first, which "
        "captures, excluded) p50 %.3f (%s) against phase 5's captured step "
        "%.3f ms; launches a TRAIN step %s, a VALID minibatch %s; losses "
        "%.4f -> %.4f; VALID loss by epoch %s; peak memory %.2f GB [%s]"
        % (setup_s, run_a_s, len(losses), step_p50,
           ", ".join("%.1f" % v for v in train_ms),
           train["step_ms"],
           STATE_LM_STEP, STATE_LM_VALID, losses[0], losses[-1],
           ["%.4f" % v for v in errors_a[1]], peak / 1e9, card))
    log("  snapshots: %d saves; a save on the training thread: the "
        "non-finite guard %s ms, the whole save (guard, host copy of the "
        "params and Adam state, pickle, enqueue) %s ms, of which the "
        "checkpointer's capture %.1f ms; the writer %.1f ms and %.1f MB "
        "a save (%.0f MB/s) [%s]" % (
            len(saves), ", ".join("%.1f" % v for v in per_save["guard_ms"]),
            ", ".join("%.1f" % v for v in per_save["save_ms"]),
            per_save["stall_ms"], per_save["writer_ms"],
            per_save["bytes"] / 1e6,
            per_save["bytes"] / 1e3 / max(per_save["writer_ms"], 1e-9),
            card))
    ck.stop()
    wf.thread_pool.shutdown()
    del wf, ck
    gc.collect()
    torch.cuda.empty_cache()

    cpu_load = _load_in_cpu_process(manifest)
    log("  %s loaded in a process without a card (CUDA_VISIBLE_DEVICES='',"
        " cuda available: %s) in %.1f s: step count %d, epoch %d"
        % (os.path.basename(manifest), cpu_load["cuda"],
           cpu_load["seconds"], cpu_load["step_count"], cpu_load["epoch"]))
    if cpu_load["cuda"]:
        raise AssertionError("the child process saw a card")

    prng.reset()
    t0 = time.monotonic()
    wf = Snapshotter.load(manifest)
    load_s = time.monotonic() - t0
    saved = wf.trainer_unit._saved_state
    if saved["step_count"] != cpu_load["step_count"] or float(
            saved["params"]["embed"].sum(dtype="f8")) != \
            cpu_load["embed_sum"]:
        raise AssertionError("the card-less load differs: %s" % cpu_load)
    wf.stopped = False
    wf.initialize(device=Device())
    steps_b = []
    run_b_s = _lm_state_run(torch, counters, wf, steps_b, [])
    _check_lm_steps("run B", steps_b)
    final_b = wf.trainer_unit._host_state()
    errors_b = {k: list(v) for k, v in wf.decision.epoch_errors.items()}
    pairs = list(zip(_state_leaves(final_a), _state_leaves(final_b)))
    bitwise = all(a.tobytes() == b.tobytes() for a, b in pairs)
    close = all(np.allclose(b, a, rtol=RESUME_RTOL, atol=RESUME_ATOL)
                for a, b in pairs)
    worst = max(float(np.max(np.abs(b.astype(np.float64) - a)))
                for a, b in pairs)
    log("  run B: the manifest loaded in %.1f s (step count %d), resumed "
        "and ran %d TRAIN steps in %.1f s; final params and Adam state "
        "against run A: bitwise %s, within rtol %g / atol %g %s (max abs "
        "difference %.3e); errors by epoch equal: %s"
        % (load_s, saved["step_count"], sum(s[0] == 2 for s in steps_b),
           run_b_s, bitwise, RESUME_RTOL, RESUME_ATOL, close, worst,
           errors_b == errors_a))
    if not close:
        raise AssertionError("the resumed run left run A's trajectory")
    wf.snapshotter.checkpointer.stop()
    wf.thread_pool.shutdown()
    del wf, final_a, final_b, pairs
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(snapdir, ignore_errors=True)
    return dict(tokens=STATE_TOKENS, epochs=STATE_EPOCHS, setup_s=setup_s,
                run_a_s=run_a_s, train_step_ms=train_ms,
                train_step_p50_ms=step_p50,
                phase5_step_ms=train["step_ms"],
                launches_train_step=STATE_LM_STEP,
                launches_valid=STATE_LM_VALID, losses=losses,
                epoch_errors=errors_a, peak_mem_bytes=peak, saves=per_save,
                checkpointer=stats, cpu_load=cpu_load, load_s=load_s,
                run_b_s=run_b_s, resumed_bitwise=bitwise,
                resumed_within_bound=close, resumed_max_abs_diff=worst,
                resumed_errors_equal=errors_b == errors_a)


def _state_kernel_holds(torch, dev, dtype, batch):
    """K6/K7 at AlexNet's two LRN shapes at this path's batch and dtype,
    and K8 at its dropout mask's shape, against their plain versions
    (comparison launches, made before the path's counts start)."""
    from veles_tpu_torch.ops import lrn, rng
    dn = str(dtype).split(".")[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    k, n, alpha, beta = LRN_SPEC
    for shape in ((batch, 55, 55, 96), (batch, 27, 27, 256)):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype) * 3
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        for name, fn in (("lrn_fwd", lambda impl: lrn.lrn_fwd(
                x, k, n, alpha, beta, impl=impl)),
                         ("lrn_bwd", lambda impl: lrn.lrn_bwd(
                             x, dy, k, n, alpha, beta, impl=impl))):
            got, want = fn("cuda").float(), fn("plain").float()
            check("%s %s %s (share of scale)" % (name, dn, list(shape)),
                  float((got - want).abs().max() / want.abs().max()),
                  TOL_LRN[dn])
    a = rng.uniform_fill(UG_SEED, (batch, 4096), device=dev, impl="cuda")
    b = rng.uniform_fill(UG_SEED, (batch, 4096), device=dev, impl="plain")
    if not bool(torch.equal(a, b)):
        raise AssertionError("uniform_fill [%d, 4096]: kernel != plain"
                             % batch)
    log("  uniform_fill [%d, 4096]: kernel == plain bitwise" % batch)


def _to_valid(loader):
    """Serve minibatches until the first of a VALID class."""
    for _ in range(100000):
        loader.run()
        if loader.minibatch_class == 1:
            return
    raise AssertionError("no VALID minibatch")


def _graph_vs_fused_valid(torch, wf, dev):
    """One VALID pass through the unit graph's forward units and
    evaluator, and the same minibatches through a FusedClassifierTrainer
    over the written-back forwards: both error counts, and the rows
    whose argmax differs with the fused logits' top-2 gap as a share of
    the logit scale."""
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    trainer = FusedClassifierTrainer.from_forwards(wf.forwards, device=dev)
    loader = wf.loader
    _to_valid(loader)
    n_graph = n_fused = 0
    gaps = []
    while True:
        size = loader.minibatch_size
        for unit in wf.forwards:
            unit.run()
        wf.evaluator.run()
        n_graph += int(wf.evaluator.n_err)
        probs = wf.forwards[-1].output.devmem[:size].float()
        logits = trainer.predict(loader.minibatch_data.devmem)[:size]
        labels = loader.minibatch_labels.devmem[:size].long()
        fused = logits.argmax(dim=-1)
        n_fused += int((fused != labels).sum())
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / logits.abs().max()
        gaps += gap[fused != probs.argmax(dim=-1)].tolist()
        if bool(loader.last_minibatch):
            break
        loader.run()
    del trainer
    return n_graph, n_fused, gaps


def state_fused_phase(torch, counters, dev, card, fused, graph):
    import gzip

    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.alexnet import AlexNetWorkflow
    from veles_tpu_torch.parallel.fused import (FusedClassifierTrainer,
                                                train_fused)
    from veles_tpu_torch.serve import (InferenceEngine, ModelRegistry,
                                       ServeServer)
    from veles_tpu_torch.snapshotter import Snapshotter

    log("phase 19b: phase 14's AlexNetWorkflow (1000 classes, 224 x 224 x "
        "3, minibatch 128, %s compute, data cut to %s) through train_fused "
        "for %d epochs, write_back, a Snapshotter snapshot, "
        "InferenceEngine.from_snapshot against from_workflow, POST /apply"
        % (root.common.engine.compute_type, UG_DATA, UG_EPOCHS))
    root.common.random.seed = UG_SEED
    prng.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wf = AlexNetWorkflow(max_epochs=UG_EPOCHS, loader_kwargs=dict(UG_DATA))
    wf.initialize(device=Device())
    mbs = wf.loader.max_minibatch_size
    steps, counts = [], []
    step, count = (FusedClassifierTrainer.step,
                   FusedClassifierTrainer.count_errors)

    def timed_step(trainer, x, labels):
        before = counters.read()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        out = step(trainer, x, labels)
        end.record()
        steps.append((start, end, _nonzero(counters.delta(before))))
        return out

    def recording(trainer, x, labels):
        counts.append(count(trainer, x, labels))
        return counts[-1]

    FusedClassifierTrainer.step = timed_step
    FusedClassifierTrainer.count_errors = recording
    try:
        t0 = time.monotonic()
        result = train_fused(wf)
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
    finally:
        FusedClassifierTrainer.step = step
        FusedClassifierTrainer.count_errors = count
    for _, _, launches in steps:
        if launches != STATE_FUSED_STEP:
            raise AssertionError("a train_fused step launched %s, not %s"
                                 % (launches, STATE_FUSED_STEP))
    step_ms = [s.elapsed_time(e) for s, e, _ in steps]
    p50 = float(np.percentile(step_ms[1:], 50))
    images_per_s = mbs * 1e3 / p50
    n_valid_mb = -(-wf.loader.class_lengths[1] // mbs)
    last_valid = sum(counts[-n_valid_mb:])
    log("  train_fused: %s in %.1f s; %d steps, device ms per step p50 %.3f"
        " (the first excluded) -> %.1f images/s, against phase 14's unit "
        "graph %.1f and phase 9's fused step %.1f images/s; launches a "
        "step %s; the closing VALID sweep %d errors of %d [%s]"
        % (result, run_s, len(steps), p50, images_per_s,
           graph["images_per_s"], fused["images_per_s"],
           STATE_FUSED_STEP, last_valid, wf.loader.class_lengths[1], card))
    n_graph, n_fused, gaps = _graph_vs_fused_valid(torch, wf, dev)
    log("  write_back, then one VALID pass: unit graph %d errors, the fused "
        "forward over the written-back params %d (train_fused's sweep %d);"
        " %d rows' argmax differ, their top-2 logit gaps %s of the logit "
        "scale (bound %.0e)" % (n_graph, n_fused, last_valid, len(gaps),
                                ["%.1e" % g for g in gaps],
                                TOL_CLASSIFIER["bfloat16"]))
    if n_fused != last_valid or any(g > TOL_CLASSIFIER["bfloat16"]
                                    for g in gaps):
        raise AssertionError("the written-back graph disagrees with "
                             "train_fused")

    snapdir = os.path.join(HERE, "chip_smoke_out", "state_fused")
    shutil.rmtree(snapdir, ignore_errors=True)
    snap = Snapshotter(wf, directory=snapdir, prefix="alexnet",
                       compression=None)
    t0 = time.monotonic()
    path = snap.save()
    save_s = time.monotonic() - t0
    size = os.path.getsize(path)
    # the "gz" codec's cost, from GZIP_SAMPLES evenly spaced slices of
    # the file (the whole file takes minutes of one core at this size)
    sample = packed = 0
    gzip_s = 0.0
    with open(path, "rb") as f:
        for i in range(GZIP_SAMPLES):
            f.seek(i * (size - GZIP_SLICE) // (GZIP_SAMPLES - 1))
            raw = f.read(GZIP_SLICE)
            t0 = time.monotonic()
            packed += len(gzip.compress(raw, compresslevel=GZIP_LEVEL))
            gzip_s += time.monotonic() - t0
            sample += len(raw)
    gzip_mb_s = sample / 1e6 / gzip_s
    log("  snapshot (compression=None) %.1f MB in %.2f s; gzip at level %d"
        " over %d slices of %d MB across it: %.1f MB/s of one core, %.3f "
        "of the size, so %.1f s for the whole snapshot [%s]"
        % (size / 1e6, save_s, GZIP_LEVEL, GZIP_SAMPLES, GZIP_SLICE >> 20,
           gzip_mb_s, packed / sample, size / 1e6 / gzip_mb_s, card))

    live = InferenceEngine.from_workflow(wf, device=dev)
    restored = InferenceEngine.from_snapshot(path, device=dev)
    rows = np.asarray(wf.loader.original_data[:8], np.float32)
    got = live.apply(rows)
    counters_before = counters.read()
    again = restored.apply(rows)
    restored_first = _nonzero(counters.delta(counters_before))
    counters_before = counters.read()
    again = restored.apply(rows)
    replay = _nonzero(counters.delta(counters_before))
    same = bool(np.array_equal(got, again))
    log("  from_snapshot == from_workflow on %d rows, bitwise: %s; "
        "launches: the first apply (capture) %s, a replay %s"
        % (len(rows), same, restored_first, replay))
    n_classes = wf.forwards[-1].output.shape[-1]
    if not same or replay != {"lrn_fwd": 2} or \
            not np.isfinite(got).all() or got.shape != (len(rows), n_classes):
        raise AssertionError("from_snapshot against from_workflow")
    registry = ModelRegistry()
    registry.add("alexnet", restored, max_batch=8, max_delay_ms=5)
    server = ServeServer(registry, port=0, timeout=600)
    try:
        url = "http://%s:%d/apply" % server.endpoint
        with _post(url, {"input": rows[:2].tolist()}) as resp:
            answer = np.asarray(json.loads(resp.read())["output"],
                                np.float32)
    finally:
        server.stop()
    check("POST /apply on the restored engine vs apply (absolute)",
          float(np.abs(answer - got[:2]).max()), TOL_APPLY)
    peak = torch.cuda.max_memory_allocated()
    wf.thread_pool.shutdown()
    del wf, live, restored, registry
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(snapdir, ignore_errors=True)
    return dict(result=result, run_s=run_s, steps=len(steps),
                step_ms=step_ms, step_p50_ms=p50, images_per_s=images_per_s,
                graph_images_per_s=graph["images_per_s"],
                fused_images_per_s=fused["images_per_s"],
                launches_step=STATE_FUSED_STEP, last_valid_errors=last_valid,
                graph_valid_errors=n_graph, fused_valid_errors=n_fused,
                argmax_flips=len(gaps), snapshot_bytes=size,
                snapshot_save_s=save_s, gzip_level=GZIP_LEVEL,
                gzip_sample_bytes=sample, gzip_s=gzip_s,
                gzip_ratio=packed / sample, gzip_mb_s=gzip_mb_s,
                gzip_whole_s=size / 1e6 / gzip_mb_s,
                apply_launches_replay=replay, peak_mem_bytes=peak)


def state_phase(torch, counters, dev, card, train, fused, graph):
    """Phase 19: the kernels of both paths held against their plain
    versions at this path's shapes, then 19a and 19b with the launch
    counts set to 0 around them."""
    log("phase 19: the state half at full width; K1-K3 at the LM's shape "
        "[8, 2048, 8, 128] bf16 are phase 2's training-shape rows")
    _state_kernel_holds(torch, dev, torch.bfloat16, 128)
    counters.reset()
    lm = state_lm_phase(torch, counters, card, train)
    classifier = state_fused_phase(torch, counters, dev, card, fused, graph)
    launches = counters.read()
    log("  launches over the phase: %s" % _nonzero(launches))
    return dict(lm=lm, classifier=classifier), launches


# ---------------------------------------------------------------------------
# phase 20: the state half, card against CPU at f32
# ---------------------------------------------------------------------------

#: the CPU tests' bound (tests/test_torch_lm_workflow.py and friends):
#: the two sides sum in different orders
TOL_STATE = 1e-4
STATE_MNIST = dict(layers=(32, 10), max_epochs=2,
                   loader_kwargs=dict(n_train=300, n_valid=100,
                                      minibatch_size=50))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _state_parity_lm(device):
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.lm import TransformerWorkflow
    prng.reset()
    wf = TransformerWorkflow(max_epochs=2, fail_iterations=100,
                             loader_kwargs=dict(n_tokens=16 * 33 * 8))
    wf.thread_pool = None
    wf.initialize(device=device)
    wf.run()
    return {k: list(v) for k, v in wf.decision.epoch_errors.items()}


def _state_parity_fused(device):
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.mnist import MnistWorkflow
    from veles_tpu_torch.parallel.fused import train_fused
    prng.reset()
    wf = MnistWorkflow(**STATE_MNIST)
    wf.thread_pool = None
    wf.initialize(device=device)
    return train_fused(wf, compute_dtype="float32"), [
        np.array(getattr(u, a).map_read())
                             for u in wf.forwards
                             for a in ("weights", "bias")]


def _state_parity_ensemble(device):
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ensemble import (EnsembleTesterWorkflow,
                                          EnsembleTrainerWorkflow)
    from veles_tpu_torch.loader.datasets import synthetic_digits
    from veles_tpu_torch.models.mnist import MnistWorkflow

    def factory(index, seed, train_ratio):
        root.common.random.seed = seed
        prng.reset()
        wf = MnistWorkflow(layers=(16, 10), max_epochs=1, loader_kwargs=dict(
            n_train=200, n_valid=80, minibatch_size=40,
            train_ratio=train_ratio))
        wf.thread_pool = None
        wf.initialize(device=device)
        wf.run()
        return wf

    root.common.random.seed = 17
    prng.reset()
    wf = EnsembleTrainerWorkflow(model_factory=factory, size=3)
    wf.thread_pool = None
    wf.initialize(device=device)
    wf.run()
    data, labels = synthetic_digits(
        200, prng.RandomGenerator("held_out", seed=123))
    tester = EnsembleTesterWorkflow(members=wf.members)
    tester.thread_pool = None
    tester.tester.data, tester.tester.labels = data, labels
    tester.initialize(device=device)
    tester.run()
    return wf.members, tester.gather_results()


def _state_parity_genetics(device):
    """Population 6, 2 generations, under a Scheduler tenant; each
    evaluation trains a small MNIST net on ``device`` at the
    chromosome's learning rate and hidden width."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics import (OptimizationWorkflow, Range,
                                          Tuneable, default_evaluator)
    from veles_tpu_torch.models.mnist import MnistWorkflow
    from veles_tpu_torch.sched import Scheduler

    def factory():
        wf = MnistWorkflow(
            layers=(root.smoke_ga.hidden, 10), max_epochs=1,
            learning_rate=root.smoke_ga.lr,
            loader_kwargs=dict(n_train=200, n_valid=80, minibatch_size=40))
        return wf

    root.common.random.seed = 17
    prng.reset()
    sched = Scheduler()
    tenant = sched.register("genetics", weight=1)
    wf = OptimizationWorkflow(
        evaluate=default_evaluator(factory, device=device), size=6,
        generations=2, sched_tenant=tenant,
        tuneables=[Tuneable("root.smoke_ga.lr", Range(0.1, 1e-3, 1.0)),
                   Tuneable("root.smoke_ga.hidden", Range(16, 4, 64))])
    wf.thread_pool = None
    evaluations = [0]
    evaluate = wf.optimizer.evaluate

    def counting(values):
        evaluations[0] += 1
        return evaluate(values)

    wf.optimizer.evaluate = counting
    wf.initialize(device=device)
    wf.run()
    quanta = sched.snapshot()["tenants"]["genetics"]["quanta"]
    sched.stop()
    results = wf.gather_results()
    del root.__dict__["smoke_ga"]
    return results, evaluations[0], quanta


def state_parity_phase(torch, dev, card):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root

    log("phase 20: the state half, Device() against Device(backend='cpu')"
        " at f32: the LM workflow (vocab 64, embed 64, 2 heads, 2 layers, "
        "seq 32) 2 epochs, train_fused(MnistWorkflow), an ensemble of 3, "
        "genetics (population 6, 2 generations) under a Scheduler tenant")
    saved = root.common.engine.compute_type, root.common.random.seed
    root.common.engine.compute_type = "float32"
    out = {}
    try:
        root.common.random.seed = 7
        card_lm, cpu_lm = (_state_parity_lm(d) for d in
                           (Device(), Device(backend="cpu")))
        err = max(_rel(card_lm[k], cpu_lm[k]) for k in (1, 2))
        check("LM loss by epoch, card vs CPU (relative)", err, TOL_STATE)
        out["lm"] = dict(card=card_lm, cpu=cpu_lm, rel_err=err)

        root.common.random.seed = 5
        (card_res, card_w), (cpu_res, cpu_w) = (
            _state_parity_fused(d) for d in (Device(),
                                             Device(backend="cpu")))
        if card_res != cpu_res:
            raise AssertionError("train_fused: card %s, CPU %s"
                                 % (card_res, cpu_res))
        err = max(_rel(a, b) for a, b in zip(card_w, cpu_w))
        check("train_fused weights, card vs CPU (share of scale)", err,
              TOL_STATE)
        out["train_fused"] = dict(result=card_res, rel_err=err)

        (card_m, card_t), (cpu_m, cpu_t) = (
            _state_parity_ensemble(d) for d in (Device(),
                                                Device(backend="cpu")))
        for a, b in zip(card_m, cpu_m):
            for key, want in b["metrics"].items():
                got = a["metrics"][key]
                if key == "loss":
                    check("ensemble member %d loss (relative)" % a["index"],
                          abs(got - want) / abs(want), TOL_STATE)
                elif got != want:
                    raise AssertionError("ensemble member %d %s: %s != %s"
                                         % (a["index"], key, got, want))
        if card_t != cpu_t:
            raise AssertionError("ensemble: card %s, CPU %s"
                                 % (card_t, cpu_t))
        log("  ensemble: member errors %s, %s on both"
            % ([m["metrics"]["min_validation_error_pt"] for m in card_m],
               card_t))
        out["ensemble"] = card_t

        (card_g, card_n, card_q), (cpu_g, cpu_n, cpu_q) = (
            _state_parity_genetics(d) for d in (Device(),
                                                Device(backend="cpu")))
        log("  genetics: %d evaluations and %d quanta on the card, %d and "
            "%d on the CPU; best %s on the card, %s on the CPU"
            % (card_n, card_q, cpu_n, cpu_q, card_g, cpu_g))
        if card_q != card_n or cpu_q != cpu_n or card_g != cpu_g:
            raise AssertionError("genetics: card vs CPU")
        out["genetics"] = dict(results=card_g, evaluations=card_n,
                               quanta=card_q)
    finally:
        root.common.engine.compute_type, root.common.random.seed = saved
    log("  every check within its bound [%s]" % card)
    return out


# ---------------------------------------------------------------------------
# phase 21: the mesh on one card
# ---------------------------------------------------------------------------

#: each world's deadline: the join, every collective and the whole run
MESH_TIMEOUT_S = 600
#: steps of every meshed leg (each against as many one-rank steps)
MESH_STEPS = 3
#: (b): the meshed bf16 LM's losses against the one-rank eager trainer's
#: (relative): the ring's per-hop bf16 rounding (2^-8 of a hop's output,
#: ``parallel/ring_attention.py``), the sequence chunk's unchunked head
#: and the gradient sums' order; the JAX package's bf16 bound for its
#: training comparisons
TOL_MESH_LM = 2e-2
#: (a) at bf16 the meshed params' distance from the one-rank params,
#: as a share of the distance the one-rank steps moved them, is held to
#: TOL_CLASSIFIER["bfloat16"] or, where larger, to twice bf16's own
#: rounding of the same steps (the one-rank f32 steps' distance from the
#: bf16 ones, measured in the phase): a mesh rounds differently (a row
#: layer's partial products, the half batch's conv algorithms), and two
#: runs each a rounding away from f32 lie about sqrt(2) of it apart.
#: At f32 (64 x 64) each leaf is held to 1e-4 of its scale.
#: (c): expert parallelism at FULL's widths, depth cut to fit the phase
MESH_MOE_LAYERS = 4
#: (d): the JAX package's only pipeline configuration (graft entry)
MESH_PIPE = dict(n_features=8, hidden=16, n_classes=6, n_stages=2)
TOL_MESH_PIPE = 1e-5


def _mesh_plan(dev):
    """What every leg runs, handed to the ranks (they import this
    module afresh, so nothing set on it in this process reaches them)."""
    return dict(batch=CLASSIFIER_BATCH, image=224, classes=1000,
                hyper=CLASSIFIER_HYPER, parity_image=64, parity_classes=10,
                parity_batch=8, full=FULL, lm_batch=TRAIN_BATCH,
                lm_lr=TRAIN_LR, moe_layers=MESH_MOE_LAYERS,
                steps=MESH_STEPS, pipe=MESH_PIPE, count=dev.type == "cuda",
                out=os.path.join("chip_smoke_out", "mesh"))


def _mesh_counters():
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.ops import lrn as lrn_ops
    from veles_tpu_torch.ops import rng as rng_ops
    return Counters(fa, lrn_ops, rng_ops)


def _mesh_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_free(torch):
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


_BATCHES = {}


def _classifier_batch(torch, plan, dev, n, image, classes, seed):
    """A seeded batch on the device, drawn once a process (bench.py's
    draw for the full-width one)."""
    key = (str(dev), n, image, classes, seed)
    if key not in _BATCHES:
        data = np.random.default_rng(seed)
        x = torch.from_numpy(data.random((n, image, image, 3),
                                         dtype=np.float32)).to(dev)
        _BATCHES[key] = (x, torch.from_numpy(
            data.integers(0, classes, n)).to(dev))
    return _BATCHES[key]


def _alexnet(plan, parity):
    from veles_tpu_torch.models.flagship import alexnet_fused
    if parity:
        return alexnet_fused(n_classes=plan["parity_classes"],
                             image_size=plan["parity_image"])[:2]
    return alexnet_fused(n_classes=plan["classes"],
                         image_size=plan["image"])[:2]


def _alexnet_batch(torch, plan, dev, parity):
    if parity:
        return _classifier_batch(torch, plan, dev, plan["parity_batch"],
                                 plan["parity_image"],
                                 plan["parity_classes"], 7)
    return _classifier_batch(torch, plan, dev, plan["batch"], plan["image"],
                             plan["classes"], 1)


def _flat(params):
    return np.concatenate([np.asarray(p[k], np.float64).ravel()
                           for p in params for k in sorted(p)])


def _param_errors(got, ref, p0):
    """(the largest max-abs error of a leaf as a share of that leaf's
    scale, the distance of ``got`` from ``ref`` over every leaf as a
    share of the distance the one-rank steps moved the params)."""
    share = max(float(np.abs(a[k] - c[k]).max() /
                      max(np.abs(c[k]).max(), 1e-30))
                for a, c in zip(got, ref) for k in c)
    moved = np.linalg.norm(_flat(ref) - _flat(p0))
    return share, float(np.linalg.norm(_flat(got) - _flat(ref)) / moved)


def _one_rank_classifier(torch, plan, dev, parity, compute=None):
    """(a)'s one-rank run, in this process: the params after the steps
    and the dropout masks of every step, saved for the ranks; and the
    params."""
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    specs, params = _alexnet(plan, parity)
    x, y = _alexnet_batch(torch, plan, dev, parity)
    kw = dict(compute_dtype="float32") if parity else dict(
        compute_dtype=compute)
    t = FusedClassifierTrainer(specs, params, device=dev, **kw,
                               **plan["hyper"])
    t.record_masks = []
    ms = []
    for _ in range(plan["steps"]):
        t0 = time.monotonic()
        t.step(x, y)
        _mesh_sync(torch, dev)
        ms.append((time.monotonic() - t0) * 1e3)
    path = os.path.join(plan["out"], "one_rank_%s.npz"
                        % ("parity" if parity else "full"))
    got = t.params_numpy()
    leaves = {"p%d_%s" % (i, k): v for i, p in enumerate(got)
              for k, v in p.items()}
    masks = {}
    for i, m in enumerate(t.record_masks):
        masks["m%d" % i] = np.packbits(m.cpu().numpy())
        masks["s%d" % i] = np.asarray(m.shape)
    if compute is None:
        np.savez(path, **leaves, **masks)
    shapes = [tuple(m.shape) for m in t.record_masks]
    del t
    _BATCHES.clear()
    _mesh_free(torch)
    return path, shapes, ms, got, params


def _mesh_classifier_leg(torch, plan, dev, mesh, tp, parity, ref, counters,
                         collectives):
    """One meshed classifier run against the one-rank file ``ref``: the
    errors of :func:`_param_errors`, the masks bitwise, the launches and
    staged bytes of each step and the step times."""
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    specs, params = _alexnet(plan, parity)
    x, y = _alexnet_batch(torch, plan, dev, parity)
    kw = dict(compute_dtype="float32") if parity else {}
    t = FusedClassifierTrainer(specs, params, mesh=mesh,
                               tensor_parallel=tp, **kw, **plan["hyper"])
    t.record_masks = []
    ms, launches, staged = [], [], []
    for _ in range(plan["steps"]):
        before, b_staged = counters.read(), sum(
            collectives.STAGED_BYTES.values())
        _mesh_sync(torch, dev)
        t0 = time.monotonic()
        t.step(x, y)
        _mesh_sync(torch, dev)
        ms.append((time.monotonic() - t0) * 1e3)
        launches.append({k: v for k, v in counters.delta(before).items()
                         if v})
        staged.append(sum(collectives.STAGED_BYTES.values()) - b_staged)
    saved = np.load(ref)
    want = [{k: saved["p%d_%s" % (i, k)] for k in p}
            for i, p in enumerate(params)]
    share, moved = _param_errors(t.params_numpy(whole=True), want, params)
    masks_equal = len(t.record_masks) == sum(
        1 for k in saved.files if k.startswith("m"))
    for i, got in enumerate(t.record_masks):
        shape = tuple(int(v) for v in saved["s%d" % i])
        full = torch.from_numpy(np.unpackbits(saved["m%d" % i])[
            :int(np.prod(shape))].reshape(shape).astype(bool))
        want = t._shards.rows(full)
        if want.shape[-1] != got.shape[-1]:
            want = want.chunk(mesh.size("model"), dim=-1)[
                mesh.index("model")]
        masks_equal &= bool(torch.equal(want.to(got.device), got))
    n_masks = len(t.record_masks)
    del t
    _mesh_free(torch)
    return dict(share_err=share, update_err=moved,
                masks_equal=masks_equal, n_masks=n_masks, ms=ms,
                launches=launches, staged=staged)


def _mesh_lm_leg(torch, plan, dev, mesh, config, tokens, counters,
                 collectives):
    from veles_tpu_torch.models.transformer import TransformerTrainer
    t = TransformerTrainer(config, mesh=mesh, seed=0,
                           learning_rate=plan["lm_lr"],
                           seq_axis="seq" if "seq" in mesh.shape else None)
    losses, ms, launches, staged = [], [], [], []
    for _ in range(plan["steps"]):
        before, b_staged = counters.read(), sum(
            collectives.STAGED_BYTES.values())
        _mesh_sync(torch, dev)
        t0 = time.monotonic()
        losses.append(float(t.step(tokens)["loss"]))
        ms.append((time.monotonic() - t0) * 1e3)
        launches.append({k: v for k, v in counters.delta(before).items()
                         if v})
        staged.append(sum(collectives.STAGED_BYTES.values()) - b_staged)
    del t
    _mesh_free(torch)
    return dict(losses=losses, ms=ms, launches=launches, staged=staged)


def mesh_rank(rank, plan):
    """A rank of (a)-(d): on the card through gloo, each leg on a mesh
    of its own over the two ranks."""
    import torch

    from veles_tpu_torch.models.transformer import TransformerConfig
    from veles_tpu_torch.parallel import collectives
    from veles_tpu_torch.parallel.mesh import MeshConfig, grid_mesh, make_mesh
    from veles_tpu_torch.parallel.pipeline import PipelineMLPTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _mesh_counters()
    counters.reset()
    collectives.reset_staged()
    mesh_dp = make_mesh(MeshConfig(data=2))
    dev = mesh_dp.device
    mesh_tp = make_mesh(MeshConfig(model=2))
    mesh_seq = make_mesh(MeshConfig(seq=2))
    out = {"device": str(dev)}
    # (a) the flagship, bf16 at full width, then f32 at 64 x 64
    for name, mesh, tp in (("dp2", mesh_dp, False), ("tp2", mesh_tp, True)):
        for parity in (False, True):
            out["a_%s_%s" % (name, "f32" if parity else "bf16")] = \
                _mesh_classifier_leg(
                    torch, plan, dev, mesh, tp, parity,
                    plan["ref_parity" if parity else "ref_full"], counters,
                    collectives)
    _BATCHES.clear()
    # (b) the LM, sequence parallel, and its f32 gradients both ways
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(
        0, plan["full"]["vocab"],
        (plan["lm_batch"], plan["full"]["seq_len"] + 1))).to(dev)
    config = TransformerConfig(compute="bfloat16", remat="attn",
                               **plan["full"])
    out["b_seq2"] = _mesh_lm_leg(torch, plan, dev, mesh_seq, config, tokens,
                                 counters, collectives)
    grads = []
    before = counters.read()
    for impl in ("cuda", "plain") if plan["count"] else ("plain", "plain"):
        from veles_tpu_torch.models.transformer import TransformerTrainer
        f32 = TransformerConfig(**dict(plan["full"], layers=2),
                                compute="float32", remat="attn",
                                attention_impl=impl)
        t = TransformerTrainer(f32, mesh=mesh_seq, seed=0)
        loss, g = t.loss_and_grads(tokens)
        grads.append((float(loss), [x.detach() for x in g]))
        del t
        _mesh_free(torch)
    (lk, gk), (lp, gp) = grads
    out["b_grad_err"] = max(float((a - c).abs().max() /
                                  c.abs().max().clamp_min(1e-30))
                            for a, c in zip(gk, gp))
    out["b_f32_losses"] = (lk, lp)
    # the comparison's launches are not the main path's
    compared = counters.delta(before)
    del grads, gk, gp
    _BATCHES.clear()
    _mesh_free(torch)
    # (c) expert parallel at FULL's widths, depth cut
    moe = TransformerConfig(compute="bfloat16", remat="attn",
                            moe_experts=2, **dict(
                                plan["full"], layers=plan["moe_layers"]))
    out["c_ep2"] = _mesh_lm_leg(torch, plan, dev, mesh_tp, moe, tokens,
                                counters, collectives)
    # (d) the pipeline, 2 stages
    pipe = grid_mesh({"pipe": 2})
    p = PipelineMLPTrainer(pipe, learning_rate=0.1, **plan["pipe"])
    prng = np.random.default_rng(1)
    px = prng.random((4, 4, plan["pipe"]["n_features"])).astype(np.float32)
    py = prng.integers(0, plan["pipe"]["n_classes"], (4, 4))
    before = p.params_numpy()
    t0 = time.monotonic()
    loss = float(p.step(px, py)["loss"])
    out["d_pipe"] = dict(loss=loss, ref=float(p.reference_loss_fn()(
        before, px, py)), ms=[(time.monotonic() - t0) * 1e3])
    out["launches"] = {k: v - compared.get(k, 0)
                       for k, v in counters.read().items()}
    return out


def nccl_rank(rank, plan):
    """(e): (a)'s data-parallel steps over NCCL with one rank, against
    the unsharded steps in this process, bitwise (two steps each, the
    second timed)."""
    import torch

    from veles_tpu_torch.models.flagship import alexnet_fused
    from veles_tpu_torch.parallel import collectives
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    from veles_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    counters = _mesh_counters()
    counters.reset()
    collectives.reset_staged()
    mesh = make_mesh(MeshConfig(data=1))
    dev = mesh.device
    specs, params, _ = alexnet_fused(n_classes=plan["classes"],
                                     image_size=plan["image"])
    x, y = _classifier_batch(torch, plan, dev, plan["batch"], plan["image"],
                             plan["classes"], 1)
    # the unsharded step is the comparison: only the NCCL step counts
    runs, compared = {}, {}
    for key, kw in (("unsharded", dict(device=dev)),
                    ("nccl", dict(mesh=mesh))):
        if key == "nccl":
            compared = counters.read()
        t = FusedClassifierTrainer(specs, params, **kw, **plan["hyper"])
        losses, ms = [], []
        for _ in range(2):      # the second step timed warm
            t0 = time.monotonic()
            losses.append(float(t.step(x, y)["loss"]))
            _mesh_sync(torch, dev)
            ms.append((time.monotonic() - t0) * 1e3)
        runs[key] = (losses, [v.detach().clone() for p in t.params
                              for v in p.values()], ms[-1])
        del t
    (lu, pu, ms_u), (ln, pn, ms_n) = runs["unsharded"], runs["nccl"]
    return dict(backend=mesh.backend, losses=(lu, ln), ms=(ms_u, ms_n),
                bitwise=all(torch.equal(a, b) for a, b in zip(pu, pn)),
                staged=sum(collectives.STAGED_BYTES.values()),
                launches=counters.delta(compared))


def _one_rank_lm(torch, plan, dev, config, tokens):
    from veles_tpu_torch.models.transformer import TransformerTrainer
    t = TransformerTrainer(config, device=dev, seed=0,
                           learning_rate=plan["lm_lr"], cuda_graphs=False)
    losses, ms = [], []
    for _ in range(plan["steps"]):
        t0 = time.monotonic()
        losses.append(float(t.step(tokens)["loss"]))
        ms.append((time.monotonic() - t0) * 1e3)
    del t
    _mesh_free(torch)
    return losses, ms


def _leg_line(name, leg, card):
    staged = np.mean(leg["staged"]) if leg.get("staged") else 0.0
    log("  %s: step p50 %.1f ms (%s ms), gloo bytes staged a step %.3e "
        "[%s]" % (name, float(np.percentile(leg["ms"], 50)),
                  ", ".join("%.1f" % v for v in leg["ms"]), staged, card))


def mesh_phase(torch, dev, card, plan=None):
    """Phase 21: ranks on one card over gloo (host-staged) and NCCL at
    world size 1; see the module docstring."""
    from veles_tpu_torch.models.transformer import TransformerConfig
    from veles_tpu_torch.parallel.multiprocess import run_world
    plan = plan or _mesh_plan(dev)
    full = plan["full"]
    log("phase 21: the mesh on one card: 2 ranks on %s over gloo (host-"
        "staged; these times say nothing of scaling over cards), %d steps "
        "a leg: (a) alexnet_fused() batch %d bf16 at data=2 and model=2 "
        "(and 64 x 64 f32), (b) the LM %s batch %d at seq=2, (c) %d-layer "
        "MoE (2 experts) at model=2, (d) the pipeline %s; (e) NCCL at "
        "world 1" % (dev, plan["steps"], plan["batch"], full,
                     plan["lm_batch"], plan["moe_layers"], plan["pipe"]))
    os.makedirs(plan["out"], exist_ok=True)
    t_phase = time.monotonic()
    try:
        ref_full, shapes, ms_one, p_one, p0 = _one_rank_classifier(
            torch, plan, dev, False)
        ref_parity = _one_rank_classifier(torch, plan, dev, True)[0]
        # bf16's own rounding of the same steps: the one-rank steps at
        # f32 against the one-rank bf16 steps
        p_f32 = _one_rank_classifier(torch, plan, dev, False,
                                     compute="float32")[3]
        floor = _param_errors(p_f32, p_one, p0)[1]
        del p_one, p0, p_f32
        plan = dict(plan, ref_full=ref_full, ref_parity=ref_parity)
        log("  one rank, (a): step p50 %.1f ms; dropout masks %s; the f32 "
            "steps off the bf16 steps by %.3e of the update [%s]"
            % (float(np.percentile(ms_one, 50)), shapes, floor, card))
        rng = np.random.default_rng(4)
        tokens = torch.from_numpy(rng.integers(
            0, full["vocab"], (plan["lm_batch"], full["seq_len"] + 1))).to(
                dev)
        lm_one, lm_ms = _one_rank_lm(torch, plan, dev, TransformerConfig(
            compute="bfloat16", remat="attn", **full), tokens)
        moe_one, _ = _one_rank_lm(torch, plan, dev, TransformerConfig(
            compute="bfloat16", remat="attn", moe_experts=2,
            **dict(full, layers=plan["moe_layers"])), tokens)
        log("  one rank, (b) eager: step p50 %.1f ms, losses %s [%s]"
            % (float(np.percentile(lm_ms, 50)), lm_one, card))
        _mesh_sync(torch, dev)
        _mesh_free(torch)
        t0 = time.monotonic()
        ranks = run_world(mesh_rank, 2, "gloo",
                          None if dev.type == "cuda" else "cpu",
                          args=(plan,), timeout_s=MESH_TIMEOUT_S)
        world_s = time.monotonic() - t0
        t0 = time.monotonic()
        if dev.type == "cuda":
            nccl = run_world(nccl_rank, 1, "nccl", None, args=(plan,),
                             timeout_s=MESH_TIMEOUT_S)[0]
        else:
            nccl = None
        nccl_s = time.monotonic() - t0
    finally:
        shutil.rmtree(plan["out"], ignore_errors=True)

    out = dict(world_s=world_s, nccl_s=nccl_s, one_rank_classifier_ms=ms_one,
               bf16_floor=floor,
               one_rank_lm_ms=lm_ms, one_rank_lm_losses=lm_one,
               one_rank_moe_losses=moe_one, ranks=ranks, nccl=nccl)
    expect_cls = {"lrn_fwd": 2, "lrn_bwd": 2, "uniform_fill": 2}
    layers = full["layers"]
    for rank, r in enumerate(ranks):
        log("  rank %d on %s:" % (rank, r["device"]))
        for key in ("a_dp2_bf16", "a_tp2_bf16", "a_dp2_f32", "a_tp2_f32"):
            leg = r[key]
            _leg_line(key, leg, card)
            log("  %s params vs one rank: %.3e of a leaf's scale, %.3e of "
                "the update" % (key, leg["share_err"], leg["update_err"]))
            if key.endswith("f32"):
                check("%s params vs one rank (share of scale)" % key,
                      leg["share_err"], TOL_CLASSIFIER["float32"])
            else:
                check("%s params vs one rank (share of update)" % key,
                      leg["update_err"],
                      max(TOL_CLASSIFIER["bfloat16"], 2 * floor))
            if not leg["masks_equal"] or leg["n_masks"] != 2 * plan["steps"]:
                raise AssertionError("%s: dropout masks differ from the one-"
                                     "rank masks (%d masks)"
                                     % (key, leg["n_masks"]))
            if plan["count"] and any(l != expect_cls
                                     for l in leg["launches"]):
                raise AssertionError("%s launches a step %s != %s"
                                     % (key, leg["launches"], expect_cls))
        log("  (a) masks bitwise the one-rank masks; K6/K7/K8 a step "
            "%s" % (expect_cls,))
        leg = r["b_seq2"]
        _leg_line("b_seq2", leg, card)
        err = max(abs(a - c) / abs(c) for a, c in zip(leg["losses"],
                                                     lm_one))
        log("  (b) losses %s vs one rank %s" % (leg["losses"], lm_one))
        check("(b) LM losses at seq=2 vs one rank (relative)", err,
              TOL_MESH_LM)
        hops = 1 + rank          # rank 1 attends to chunk 0 too
        want = {"flash_fwd": 2 * layers * hops,
                "flash_bwd_dkv": layers * hops,
                "flash_bwd_dq": layers * hops}
        if plan["count"] and any(l != want for l in leg["launches"]):
            raise AssertionError("(b) rank %d launches a step %s != %s"
                                 % (rank, leg["launches"], want))
        log("  (b) K1/K2/K3 a step on rank %d: %s (%d hop(s) a layer, "
            "remat 'attn' runs each forward hop twice)" % (rank, want, hops))
        check("(b) f32 2-layer ring grads, K1-K3 vs plain (share)",
              r["b_grad_err"], TOL_GRAD["float32"])
        leg = r["c_ep2"]
        _leg_line("c_ep2", leg, card)
        err = max(abs(a - c) / abs(c) for a, c in zip(leg["losses"],
                                                     moe_one))
        log("  (c) losses %s vs one rank %s" % (leg["losses"], moe_one))
        check("(c) MoE losses at model=2 vs one rank (relative)", err,
              TOL_MESH_LM)
        want = {k: plan["moe_layers"] for k in
                ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
        if plan["count"] and any(l != want for l in leg["launches"]):
            raise AssertionError("(c) launches a step %s != %s"
                                 % (leg["launches"], want))
        leg = r["d_pipe"]
        log("  (d) pipeline loss %.6f, sequential %.6f, step %.1f ms [%s]"
            % (leg["loss"], leg["ref"], leg["ms"][0], card))
        check("(d) pipeline loss vs reference_loss_fn (relative)",
              abs(leg["loss"] - leg["ref"]) / abs(leg["ref"]), TOL_MESH_PIPE)
    if nccl is not None:
        log("  (e) NCCL world 1 (%s): second step %.1f ms vs unsharded "
            "%.1f ms, losses %s, staged bytes %d, params bitwise the "
            "unsharded steps: %s [%s]" % (nccl["backend"], nccl["ms"][1], nccl["ms"][0],
                               nccl["losses"], nccl["staged"],
                               nccl["bitwise"], card))
        if nccl["backend"] != "nccl" or not nccl["bitwise"] or \
                nccl["staged"]:
            raise AssertionError("(e) NCCL at world 1: %s" % (nccl,))
    launches = {}
    for r in ranks + ([nccl] if nccl is not None else []):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["wall_s"] = time.monotonic() - t_phase
    log("  phase 21 %.1f s (world of 2: %.1f s, NCCL world: %.1f s); "
        "launches over the ranks %s [%s]"
        % (out["wall_s"], world_s, nccl_s, launches, card))
    return out, launches


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
    pipeline, pipeline_launches = pipeline_phase(torch, counters, dev, card)
    zoo, zoo_launches = zoo_phase(torch, counters, dev, card)
    zoo_parity = zoo_parity_phase(torch, dev, card)
    state, state_launches = state_phase(torch, counters, dev, card, train,
                                        classifier, classifier_graph)
    state_parity = state_parity_phase(torch, dev, card)
    mesh, mesh_launches = mesh_phase(torch, dev, card)

    # each main path's launches, counted from 0 around that path alone
    by_path = {"serving": serve_launches, "training": train_launches,
               "paged serving": paged_launches,
               "classifier training": classifier_launches,
               "apply serving": apply_launches,
               "unit graph": graph_launches,
               "co-tenancy": cotenancy_launches,
               "unit-graph classifier": classifier_graph_launches,
               "input pipeline": pipeline_launches,
               "unit families and zoo": zoo_launches,
               "state": state_launches,
               "mesh": mesh_launches}
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
                  input_pipeline=pipeline, zoo=zoo, zoo_parity=zoo_parity,
                  state=state, state_parity=state_parity, mesh=mesh,
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
