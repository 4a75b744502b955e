#!/usr/bin/env python3
"""The port's bf16 flash-attention kernels on one GPU, for comparing
checkouts: a correctness sweep of K1 (forward), K2 (dK/dV) and K3 (dQ)
against the plain PyTorch versions at the edges of their tiles (D
32/64/128, ragged and causal T, a second launch bitwise equal), then
each kernel's time at
the main paths' shapes (K1 at serving `[2, 2048, 8, 128]` and training
`[8, 2048, 8, 128]` on strided views of one QKV projection; K2 and K3
at training) as device time (``chip_smoke.device_ms`` of this
checkout: torch.profiler's kernel time) and as
CUDA-event time of back-to-back calls, which includes the host's launch
rate. ``--sdpa`` also times scaled_dot_product_attention on the same
inputs; ``--lm`` then trains the full-width LM on the checkout's
package with this checkout's ``chip_smoke.training_phase`` (phase 5:
ms per step over a timed window, the step's device time and busy
share, the flash kernels' device time). ``--decode`` runs the decode
kernels instead: a sweep of K4 (slab) and K5 (pages) against the plain
versions (D 32/64/128, bf16 and f32, lengths around a 128-key chunk
edge, a second launch bitwise equal, K5 bitwise equal to K4 on the same
K/V), then both at phase 2's shape (q [8, 8, 128] over a
``[8, 2048, 8, 128]`` bf16 slab, lengths 0 to 2048, K5 over the same
K/V in 16-token pages in a scrambled order) by device time with the L2
flushed before each call and by back-to-back event time; with
``--sdpa`` also SDPA and the page gather + SDPA on the same inputs.
``--lrn`` runs the LRN kernels instead: a sweep of K6 (forward) and K7
(backward) against the plain versions (C from 8 to 4104 at row counts
that leave a chunk part full, windows 2 to 11, f32 and bf16, a second
launch bitwise equal, a base one element off 16 bytes and a row stride
off 16 bytes bitwise equal to the aligned tensor), the registers,
spills and SASS instruction mix of the 16-byte window-5 instances (the
main path's), then both kernels by device time at AlexNet's LRN1
``[1536, 55, 55, 96]`` and LRN2 ``[1536, 27, 27, 256]`` in bf16 and
f32 beside their bytes bound; ``--step`` then runs phase 9's classifier
step (``chip_smoke.classifier_phase``: ms per step, images/s, the
step's device time and its LRN and fill kernels).

    PKG=<checkout> TAG=<label> python3 scripts/torch_flash_ab.py [--sdpa] [--lm]
    PKG=<checkout> TAG=<label> python3 scripts/torch_flash_ab.py --decode [--sdpa]
    PKG=<checkout> TAG=<label> python3 scripts/torch_flash_ab.py --lrn [--step]

``PKG`` names the checkout whose ``veles_tpu_torch`` is timed (default:
this one); compare two checkouts in one run on one card, in turns
(parent, change, change, parent). Needs one CUDA card and ``nvcc``.
"""

import importlib.util
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.environ.get("PKG") or ROOT)

from veles_tpu_torch.ops import _build  # noqa: E402
from veles_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _smoke():
    """This checkout's chip_smoke.py, for its device_ms."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

TAG = os.environ.get("TAG", "")


def event_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


#: phase 2's decode lengths, and the chunk-edge lengths of the sweep
DECODE_LENGTHS = [0, 1, 777, 2048, 1500, 64, 1024, 2000]
EDGE = 128


def _pages(k, v, ps, extra, rng):
    """The slab's K/V in ps-row pages in a scrambled order, with a block
    table that ends in ``extra`` sentinel entries (id P) per sequence."""
    b, s, h, d = k.shape
    used = -(-s // ps)
    perm = torch.from_numpy(rng.permutation(b * used)).cuda()
    pools = []
    for x in (k, v):
        rows = torch.zeros((b, used * ps, h, d), dtype=x.dtype, device="cuda")
        rows[:, :s] = x
        pool = torch.empty((b * used, ps, h, d), dtype=x.dtype,
                           device="cuda")
        pool[perm] = rows.reshape(b * used, ps, h, d)
        pools.append(pool)
    table = torch.full((b, used + extra), b * used, dtype=torch.int32,
                       device="cuda")
    table[:, :used] = perm.reshape(b, used).to(torch.int32)
    return pools[0], pools[1], table


def decode_main(smoke):
    t0 = time.time()
    _build.build(["flash_decode"])
    print(TAG, "build %.1f s" % (time.time() - t0), flush=True)
    rng = np.random.default_rng(0)

    def randn(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(dtype)

    bad = 0
    s = 4 * EDGE + 37
    lengths = torch.tensor([0, EDGE - 1, EDGE, EDGE + 1, 3 * EDGE + 5, s],
                           dtype=torch.int32, device="cuda")
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        for d in (128, 64, 32):
            k, v = randn((6, s, 3, d), dtype), randn((6, s, 3, d), dtype)
            q = randn((6, 3, d), dtype)
            kp, vp, table = _pages(k, v, 16, 9, rng)
            out = fa.flash_decode_cuda(q, k, v, lengths)
            again = fa.flash_decode_cuda(q, k, v, lengths)
            paged = fa.flash_decode_paged_cuda(q, kp, vp, table, lengths)
            ref = fa.flash_decode(q, k, v, lengths, impl="plain")
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            ok = bool((err <= tol + tol * ref.float().abs()).all()) and \
                torch.equal(out, again) and torch.equal(out, paged) and \
                float(out[0].abs().max()) == 0.0
            bad += not ok
            print(TAG, "%s D=%d: max err %.2e, again bitwise %s, K5 == K4 "
                  "bitwise %s %s" % (str(dtype)[6:], d, float(err.max()),
                                     torch.equal(out, again),
                                     torch.equal(out, paged),
                                     "ok" if ok else "FAIL"), flush=True)
    print(TAG, "failed cases", bad, flush=True)

    b, s, h, d = 8, 2048, 8, 128
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    k, v = randn((b, s, h, d), torch.bfloat16), randn((b, s, h, d),
                                                       torch.bfloat16)
    q = randn((b, h, d), torch.bfloat16)
    kp, vp, table = _pages(k, v, 16, 0, rng)
    live = (torch.arange(table.shape[1], device="cuda")[None, :] <
            ((lengths + 15) // 16)[:, None])
    table = torch.where(live, table, torch.full_like(table, kp.shape[0]))
    rows = [("K4 slab", lambda: fa.flash_decode_cuda(q, k, v, lengths)),
            ("K5 paged", lambda: fa.flash_decode_paged_cuda(
                q, kp, vp, table, lengths))]
    if "--sdpa" in sys.argv:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask = (torch.arange(s, device="cuda")[None, :] <
                lengths[:, None])[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        safe = table.clamp(max=kp.shape[0] - 1).long()
        rows += [("SDPA slab", lambda: sdpa(q[:, :, None], kt, vt,
                                            attn_mask=mask)),
                 ("gather + SDPA", lambda: sdpa(
                     q[:, :, None],
                     kp[safe].reshape(b, s, h, d).transpose(1, 2),
                     vp[safe].reshape(b, s, h, d).transpose(1, 2),
                     attn_mask=mask))]
    live_bytes = 2 * int(lengths.sum()) * h * d * 2
    for name, fn in rows:
        ev, dev = event_ms(fn, 50), smoke.device_ms(fn, 50, cold=True)
        print(TAG, "%-14s device %.4f ms cold L2 (%.0f GB/s of live K/V), "
              "back to back %.4f ms" % (name, dev, live_bytes / dev / 1e6,
                                        ev), flush=True)
        for flush in ("write", "read", None):
            print(TAG, "  by kernel, L2 %s: %s" % (
                {"write": "dirty", "read": "clean", None: "warm"}[flush],
                "; ".join("%s %.4f ms" % kv
                          for kv in by_kernel(smoke, fn, flush))),
                flush=True)
    return 1 if bad else 0


#: the --lrn sweep: (rows, C, window); rows leave the last chunk part full
LRN_EDGES = [(37, 8, 5), (45, 16, 3), (19, 24, 7), (41, 96, 9),
             (13, 256, 11), (7, 264, 2), (3, 4104, 5), (1001, 37, 4),
             (97, 96, 5), (33, 256, 5)]


def _lrn_case(lrn, x, dy, n):
    k, alpha, beta = 2.0, 5e-3, 0.75
    return (lrn.lrn_fwd(x, k, n, alpha, beta, impl="cuda"),
            lrn.lrn_bwd(x, dy, k, n, alpha, beta, impl="cuda"),
            lrn.lrn_fwd(x, k, n, alpha, beta, impl="plain"),
            lrn.lrn_bwd(x, dy, k, n, alpha, beta, impl="plain"))


#: SASS opcodes counted per LRN instance, by class
SASS_CLASSES = (("MUFU", r"\bMUFU\."), ("SHFL", r"\bSHFL\."),
                ("FADD", r"\bFADD\b"), ("FMUL", r"\bFMUL\b"),
                ("F2FP", r"\bF2FP\."), ("LDG", r"\bLDG\."),
                ("STG", r"\bSTG\."), ("MOV", r"\bMOV\b"))


def lrn_units(smoke, lib_path):
    """Registers, spill bytes and the SASS instruction mix (all
    instructions, and those of SASS_CLASSES) of the window-5 instances
    of K6 and K7 whose lanes load 16 bytes."""
    import re
    text = smoke.sass_text(lib_path)
    usage = smoke.ptxas_usage(_build.build_log("lrn"))
    bodies, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            bodies[name] = []
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            bodies[name].append(line)
    plain = smoke.demangle(bodies)
    for mangled, lines in sorted(bodies.items(), key=lambda kv: plain[kv[0]]):
        kernel = plain[mangled]
        if not re.search(r"lrn_(fwd|bwd)_kernel<(__nv_bfloat16, 8|float, 4), "
                         r"5>", kernel):
            continue
        mix = ", ".join("%s %d" % (op, sum(bool(re.search(pat, x))
                                          for x in lines))
                        for op, pat in SASS_CLASSES)
        print(TAG, "%s: %s; SASS %d instructions (%s)" % (
            kernel, "; ".join(usage.get(kernel, [])), len(lines), mix),
            flush=True)


def lrn_main(smoke):
    from veles_tpu_torch.ops import lrn
    from veles_tpu_torch.ops import rng as rng_ops
    t0 = time.time()
    libs = _build.build(["lrn", "rng"])
    print(TAG, "build %.1f s" % (time.time() - t0), flush=True)
    gen = np.random.default_rng(0)
    bad = 0
    for dtype in (torch.bfloat16, torch.float32):
        tol = smoke.TOL_LRN[str(dtype)[6:]]
        for m, c, n in LRN_EDGES:
            x = torch.from_numpy(gen.standard_normal((m, c)).astype(
                np.float32) * 3).cuda().to(dtype)
            dy = torch.from_numpy(gen.standard_normal((m, c)).astype(
                np.float32)).cuda().to(dtype)
            y, dx, py, pdx = _lrn_case(lrn, x, dy, n)
            again = _lrn_case(lrn, x, dy, n)[:2]
            same = torch.equal(y, again[0]) and torch.equal(dx, again[1])
            for offset, stride in ((1, c), (0, c + 3)):
                bufs = [torch.zeros(m * stride + 1, dtype=dtype,
                                    device="cuda") for _ in range(2)]
                xv, dyv = (b[offset:offset + m * stride].view(
                    m, stride)[:, :c] for b in bufs)
                xv.copy_(x)
                dyv.copy_(dy)
                got = _lrn_case(lrn, xv, dyv, n)[:2]
                same = same and torch.equal(got[0], y) and \
                    torch.equal(got[1], dx)
            torch.cuda.synchronize()
            ey, ed = (float((a.float() - b.float()).abs().max() /
                            b.float().abs().max()) for a, b in
                      ((y, py), (dx, pdx)))
            ok = ey <= tol and ed <= tol and same
            bad += not ok
            print(TAG, "%s [%d, %d] n=%d: fwd %.2e bwd %.2e (share of "
                  "scale), repeat/unaligned/strided bitwise %s %s" % (
                      str(dtype)[6:], m, c, n, ey, ed, same,
                      "ok" if ok else "FAIL"), flush=True)
    print(TAG, "failed cases", bad, flush=True)
    lrn_units(smoke, libs["lrn"])

    k, n, alpha, beta = smoke.LRN_SPEC
    b = smoke.CLASSIFIER_BATCH
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape in (("LRN1", (b, 55, 55, 96)),
                            ("LRN2", (b, 27, 27, 256))):
            x = torch.randn(shape, device="cuda").to(dtype) * 3
            dy = torch.randn(shape, device="cuda").to(dtype)
            nbytes = x.numel() * x.element_size()
            for kern, fn, moved in (
                    ("K6", lambda: lrn.lrn_fwd_cuda(x, k, n, alpha, beta),
                     2 * nbytes),
                    ("K7", lambda: lrn.lrn_bwd_cuda(x, dy, k, n, alpha,
                                                    beta), 3 * nbytes)):
                dev = smoke.device_ms(fn, 20)
                bound = moved / smoke.PEAK_BYTES * 1e3
                print(TAG, "%s %s %s: device %.4f ms, bound %.4f ms (share "
                      "%.3f, %.0f GB/s), back to back %.4f ms" % (
                          kern, name, str(dtype)[6:], dev, bound,
                          bound / dev, moved / dev / 1e6, event_ms(fn)),
                      flush=True)
            del x, dy
    if "--step" not in sys.argv:
        return 1 if bad else 0

    from veles_tpu_torch.ops import flash_attention as fa_ops
    smoke.log = lambda msg: None
    counters = smoke.Counters(fa_ops, lrn, rng_ops)
    res, _ = smoke.classifier_phase(torch, counters, torch.device("cuda", 0),
                                    smoke.card_line())
    prof = res["profile"] or {}
    print(TAG, "classifier step %.3f ms (step_many %.3f), %.1f images/s; "
          "device %.3f ms per step, busy %.3f; LRN and fill kernels %.3f ms"
          % (res["step_ms"], res["step_many_ms_per_step"],
             res["images_per_s"], prof.get("device_ms", 0.0),
             prof.get("busy_share", 0.0),
             prof.get("by_class", {}).get("LRN and fill kernels", 0.0)),
          flush=True)
    print(TAG, "  by class: %s" % "; ".join(
        "%s %.3f" % kv for kv in sorted(prof.get("by_class", {}).items(),
                                       key=lambda kv: -kv[1])), flush=True)
    return 1 if bad else 0


def by_kernel(smoke, fn, flush="write", reps=50):
    """Device time of one ``fn()`` per kernel (name, ms), the L2 cache
    before each call left dirty (``"write"``: 100 MB written, as
    ``chip_smoke.device_ms(cold=True)`` flushes, so the call's reads also
    pay for writing those lines back), clean (``"read"``: 100 MB read)
    or warm (None); the flush's own kernels left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    big = torch.empty(2 * smoke.L2_BYTES // 4, dtype=torch.float32,
                      device="cuda")
    step = {"write": big.zero_, "read": big.sum, None: lambda: None}[flush]

    def kernels(body):
        body()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                body()
            torch.cuda.synchronize()
            time.sleep(smoke.EDGE_PAUSE_S)
        return {e.key: e.self_device_time_total / reps / 1e3
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count}

    skip = set(kernels(step))

    def timed():
        step()
        fn()

    return [(key[:48], ms) for key, ms in kernels(timed).items()
            if key not in skip]


def main():
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    if "--decode" in sys.argv:
        return decode_main(_smoke())
    if "--lrn" in sys.argv:
        return lrn_main(_smoke())
    t0 = time.time()
    _build.build(["flash_fwd", "flash_bwd"])
    print(TAG, "build %.1f s" % (time.time() - t0), flush=True)
    rng = np.random.default_rng(0)

    def randn(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(torch.bfloat16)

    bad = 0
    for d in (128, 64, 32):
        for t, causal in ((1, True), (63, False), (129, True),
                          (1000, True), (2048, True)):
            q, k, v, do = (randn((2, t, 4, d)) for _ in range(4))
            o, l, m = fa.flash_fwd_cuda(q, k, v, causal)
            again = fa.flash_fwd_cuda(q, k, v, causal)
            po, pl, pm = fa.flash_attention_fwd(q, k, v, causal=causal,
                                                impl="plain")
            di = torch.einsum("bqhd,bqhd->bhq", do.float(),
                              o.float()).contiguous()
            dq = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, causal)
            dq2 = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, causal)
            dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, causal)
            dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, causal)
            pq, pk, pv = fa._plain_bwd(q, k, v, o, l, m, do, causal, t, t)
            torch.cuda.synchronize()
            eo = float((o.float() - po.float()).abs().max())
            el = float(((l - pl).abs() / pl.abs()).max())
            em = float((m - pm).abs().max())
            eq, ek, ev = (float((a.float() - b.float()).abs().max() /
                                b.float().abs().max().clamp_min(1.0))
                          for a, b in ((dq, pq), (dk, pk), (dv, pv)))
            same = all(torch.equal(a, b) for a, b in zip(
                (o, l, m, dq, dk, dv), again + (dq2, dk2, dv2)))
            ok = eo <= 2e-2 and el <= 1e-4 and em <= 1e-4 and \
                max(eq, ek, ev) <= 2e-2 and same
            bad += not ok
            if not ok or t == 2048:
                print(TAG, "D=%d T=%d causal=%d: O %.2e l %.2e m %.2e dq "
                      "%.2e dk %.2e dv %.2e bitwise %s %s" % (
                          d, t, causal, eo, el, em, eq, ek, ev, same,
                          "ok" if ok else "FAIL"), flush=True)
    print(TAG, "failed cases", bad, flush=True)

    qkv = randn((8, 2048, 3, 8, 128))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = randn((8, 2048, 8, 128))
    o, l, m = fa.flash_fwd_cuda(q, k, v, True)
    di = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()
    qs, ks, vs = (randn((2, 2048, 8, 128)) for _ in range(3))
    pairs = 2048 * 2049 / 2 * 8 * 128   # causal pairs x heads x D
    rows = [("K1 serving", lambda: fa.flash_fwd_cuda(qs, ks, vs, True),
             4 * 2 * pairs),
            ("K1 training", lambda: fa.flash_fwd_cuda(q, k, v, True),
             4 * 8 * pairs),
            ("K3 training", lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, l, m, di, True), 6 * 8 * pairs),
            ("K2 training", lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, do, l, m, di, True), 8 * 8 * pairs),
            ("K2+K3 training", lambda: (
                fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True),
                fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, True)),
             14 * 8 * pairs)]
    if "--sdpa" in sys.argv:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        st = [x.transpose(1, 2) for x in (qs, ks, vs)]
        tt = [x.transpose(1, 2) for x in (q, k, v)]
        tg = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        out = sdpa(*tg, is_causal=True)
        rows += [("SDPA serving", lambda: sdpa(*st, is_causal=True),
                  4 * 2 * pairs),
                 ("SDPA training", lambda: sdpa(*tt, is_causal=True),
                  4 * 8 * pairs),
                 ("SDPA backward", lambda: torch.autograd.grad(
                     out, tg, do.transpose(1, 2), retain_graph=True),
                  10 * 8 * pairs)]
    smoke = _smoke()
    for name, fn, flops in rows:
        ev, dev = event_ms(fn), smoke.device_ms(fn, 20)
        print(TAG, "%-14s device %.4f ms (%.0f TFLOP/s), back to back "
              "%.4f ms" % (name, dev, flops / dev / 1e9, ev), flush=True)
    if "--lm" in sys.argv:
        smoke.log = lambda msg: None
        train, _ = smoke.training_phase(torch, fa, torch.device("cuda", 0),
                                        smoke.card_line())
        prof = train["profile"] or {}
        print(TAG, "LM step %.3f ms (step_many %.3f), %.1f tokens/s; "
              "device %.3f ms per step, busy %.3f, flash kernels %.3f ms"
              % (train["step_ms"], train["step_many_ms_per_step"],
                 train["tokens_per_s"], prof.get("device_ms", 0.0),
                 prof.get("busy_share", 0.0),
                 prof.get("by_class", {}).get("flash kernels", 0.0)),
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
