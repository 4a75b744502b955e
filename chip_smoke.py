#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero
without them, and on any failed phase. Phases, in order:

1. device: the card's name and power limit (``nvidia-smi``), then the
   build of every kernel in ``veles_tpu_torch/ops/csrc`` (parallel
   ``nvcc``, timed, with ``ptxas`` register/spill lines);
2. kernels: each kernel against its plain PyTorch version on the card
   at the serving path's shapes (max errors against stated
   tolerances), with the kernel's, the plain version's and one
   library call's time and the card's lower bound for the work;
3. serving at full width: the repo's largest LM configuration
   (``bench_transformer.py``: vocab 8192, embed 1024, 8 heads of 128,
   12 layers, seq 2048, bf16) with random seeded weights behind
   ``GenerativeEngine`` -> ``ModelRegistry`` -> ``ServeServer``, eight
   ``POST /generate`` requests (one streaming), the kernels' launch
   counters read around them; then prefill and decode timed on the
   engine directly;
4. parity on the card: greedy tokens through the kernels equal the
   plain path's over 32 steps on a 2-layer f32 copy of the same width;
   the bf16 full-width prefill logits against the plain path.

It prints the per-kernel JSON line and the card line before its last
line, ``{"ok": true, "device": {...}}``; the full record goes to
``chip_smoke_out/chip_smoke.json`` (gitignored).
"""

import json
import os
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

#: stated tolerances, kernel vs plain PyTorch on the same inputs: f32
#: differs only in the order of f32 sums; bf16 rounds p and the output
#: to bf16 at different points of the two sums (a few bf16 ulps of a
#: unit-scale output). The f32 residuals l, m see identical scores up
#: to f32 sum order in both dtypes.
TOL_OUT = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_L_REL = 1e-4
TOL_M = 1e-4

FULL = dict(vocab=8192, embed=1024, heads=8, layers=12, seq_len=2048)


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


def profile_device(torch, fn, steps):
    """Device time by kernel over ``steps`` calls of ``fn`` (which ends
    on the host, synchronized): torch.profiler's CUDA kernel records,
    their sum per call, and the device's busy share of the wall time.
    ``None`` when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms,
                top=[dict(kernel=k[:80], ms=ms, launches=n)
                     for k, ms, n in rows[:8]])


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
            po, pl, pm = fa.flash_attention_fwd(q, k, v, causal=True,
                                                impl="plain")
            torch.cuda.synchronize()
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
                ms = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, True), 20)
                plain_ms = time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, causal=True, impl="plain"), 3)
                lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                                 20)
                bms, by = bound(flops, nbytes, dn)
                rows["flash_fwd"] = dict(
                    name="flash_fwd", route="cuda",
                    source="veles_tpu_torch/ops/csrc/flash_fwd.cu",
                    replaces="veles_tpu/ops/flash_attention.py:346",
                    shape="q,k,v [2, 2048, 8, 128] bf16, causal",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)
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
        if dtype is torch.bfloat16:
            live = int(lengths.sum())
            flops = 4.0 * d * h * live
            nbytes = (2 * live * h * d + 2 * b * h * d) * \
                q.element_size() + 4 * b
            mask = (torch.arange(s, device=dev)[None, :] <
                    lengths[:, None])[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            ms = time_ms(lambda: fa.flash_decode_cuda(q, kc, vc, lengths),
                         50)
            plain_ms = time_ms(lambda: fa.flash_decode(
                q, kc, vc, lengths, impl="plain"), 5)
            lib_ms = time_ms(lambda: sdpa(q4, kt, vt, attn_mask=mask), 50)
            bms, by = bound(flops, nbytes, dn)
            rows["flash_decode"] = dict(
                name="flash_decode", route="cuda",
                source="veles_tpu_torch/ops/csrc/flash_decode.cu",
                replaces="veles_tpu/ops/flash_attention.py:796",
                shape="q [8, 8, 128], slab [8, 2048, 8, 128] bf16, "
                      "lengths %s" % lengths.tolist(),
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)
    for row in rows.values():
        log("  %s: kernel %.4f ms, plain %.4f ms, library %.4f ms, "
            "bound %.4f ms (%s) [%s]" % (
                row["name"], row["ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"], row["bound_by"],
                row["shape"]))
    return rows


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
    del params
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
        rng = np.random.default_rng(1)
        plens = [16, 100, 250, 500, 777, 1000, 1250, 1500]
        n_tok = 32
        prompts = [rng.integers(1, config.vocab, n).tolist()
                   for n in plens]
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
        result["http"] = dict(requests=len(prompts), prompt_lens=plens,
                              tokens_each=n_tok, wall_s=wall,
                              tokens_per_s=len(prompts) * n_tok / wall,
                              prefills=admits, decode_steps=steps,
                              launches=launches,
                              metrics=metrics_json["lm"])
    finally:
        server.stop()

    # prefill and decode timed on the engine directly (host clock; the
    # engine hands tokens to the host, so each call ends synchronized)
    rng = np.random.default_rng(2)
    batch = [rng.integers(1, config.vocab, 1024) for _ in range(8)]
    slots, _ = engine.admit(batch)
    for s in slots:
        engine.release(s)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    slots, _ = engine.admit(batch)
    prefill_ms = (time.monotonic() - t0) * 1e3
    engine.decode()
    t0 = time.monotonic()
    n_steps = 32
    for _ in range(n_steps):
        engine.decode()
    decode_ms = (time.monotonic() - t0) * 1e3 / n_steps
    log("  engine: prefill 8 x 1024 tokens %.2f ms; decode step over 8 "
        "slots %.3f ms = %.1f tokens/s [%s]"
        % (prefill_ms, decode_ms, 8 * 1e3 / decode_ms, card))
    prof_decode = profile_device(torch, engine.decode, 8)
    for s in slots:
        engine.release(s)

    def admit_release():
        for s in engine.admit(batch)[0]:
            engine.release(s)

    prof_prefill = profile_device(torch, admit_release, 2)
    for what, prof in (("decode step", prof_decode),
                       ("prefill 8 x 1024", prof_prefill)):
        if prof is None:
            log("  profile %s: no device time recorded" % what)
            continue
        log("  profile %s: wall %.3f ms, device %.3f ms (busy %.0f%%); "
            "top kernels: %s" % (
                what, prof["wall_ms"], prof["device_ms"],
                100 * prof["busy_share"],
                "; ".join("%s %.3f ms x%g" % (r["kernel"][:40], r["ms"],
                                              r["launches"])
                          for r in prof["top"][:5])))
    result["engine"] = dict(prefill_8x1024_ms=prefill_ms,
                            decode_step_ms=decode_ms,
                            decode_tokens_per_s=8 * 1e3 / decode_ms,
                            peak_mem_bytes=torch.cuda.max_memory_allocated(),
                            profile_decode=prof_decode,
                            profile_prefill=prof_prefill)
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from veles_tpu_torch.ops import _build
        from veles_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print("chip_smoke: the port is not beside this script (%s)" % e,
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log("phase 1: card %s; torch %s, CUDA %s" % (
        card, torch.__version__, torch.version.cuda))
    t0 = time.monotonic()
    _build.build()
    build_s = time.monotonic() - t0
    log("  built %s in %.1f s" % (_build.sources(), build_s))
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("    %s: %s" % (name, line.strip()))

    rows = kernel_phase(torch, fa, dev)
    serve, launches = serving_phase(torch, fa, dev, card)
    parity = parity_phase(torch, dev)

    kernels = []
    for name, row in rows.items():
        row = dict(row, launches=launches[name])
        row["max_err"] = row["max_abs_err"]
        row["kernel_ms"] = row["ms"]
        kernels.append(row)
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  kernels=kernels, serving=serve, parity=parity)
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
    sys.exit(main())
