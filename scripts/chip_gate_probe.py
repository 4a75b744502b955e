"""Does ``python -m veles_tpu_torch.analysis`` (chip_smoke.py phase 26's
gate) touch the card, and does it slow a host-bound card loop beside it?

Times a loop of small CUDA ops alone, then beside the gate, and lists the
card's compute apps (``nvidia-smi``) while the gate runs; prints one JSON
line at the end. Run from the repo's root on a machine with a card:
``python3 scripts/chip_gate_probe.py`` (about a minute)."""
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def loop(seconds):
    x = torch.randn(256, 256, device="cuda")
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            x = torch.tanh(x @ x * 1e-3)
        torch.cuda.synchronize()
        n += 50
    return n / (time.perf_counter() - t0)


def apps():
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout
    return [l.strip() for l in out.splitlines() if l.strip()]


print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
loop(2)
alone = loop(10)
print("alone ops/s %.0f; apps %s" % (alone, apps()), flush=True)
t0 = time.monotonic()
proc = subprocess.Popen([sys.executable, "-m", "veles_tpu_torch.analysis",
                         "--json", os.path.join(tempfile.mkdtemp(),
                                                "gate.json")],
                        cwd=ROOT, stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)
rates, seen = [], []
while proc.poll() is None and time.monotonic() - t0 < 120:
    rates.append(loop(5))
    a = apps()
    seen.append(any(l.startswith("%d," % proc.pid) for l in a))
    print("beside gate t=%.0f ops/s %.0f gate on card %s apps %s"
          % (time.monotonic() - t0, rates[-1], seen[-1], a), flush=True)
proc.kill()
proc.wait()
print("gate rc %s after %.1f s" % (proc.returncode, time.monotonic() - t0))
print(json.dumps({"alone": alone, "beside": rates, "gate_on_card": seen}))
