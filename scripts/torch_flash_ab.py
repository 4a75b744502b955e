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
share, the flash kernels' device time).

    PKG=<checkout> TAG=<label> python3 scripts/torch_flash_ab.py [--sdpa] [--lm]

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


def main():
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
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
