#!/usr/bin/env python3
"""Register use of one kernel library of the port, per kernel: what
ptxas reports (registers at launch, spill stores and loads, C7512
warnings that it serialised wgmma), and what the SASS shows (the highest
register named, local-memory stores, HGMMA instructions and the wgmma
waits ``WARPGROUP.DEPBAR``: one per HGMMA means every product waits for
the one before).

    PKG=<checkout> python3 scripts/torch_kernel_regs.py [library]

``library`` is a source of ``veles_tpu_torch/ops/csrc`` (default
``flash_bwd``); ``PKG`` names the checkout whose sources are built
(default: this one). Needs ``nvcc`` and ``cuobjdump`` (the CUDA
toolkit), not a card.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.environ.get("PKG") or ROOT)

from veles_tpu_torch.ops import _build  # noqa: E402


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "flash_bwd"
    lib = _build.build([name])[name]
    log = _build.build_log(name)
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    ptxas, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            kernel = m.group(1)
        elif kernel and ("spill" in line or "Used" in line):
            ptxas.setdefault(kernel, []).append(line.split(":")[-1].strip())
    serialised = set(re.findall(r"C7512\).*function '(\w+)'", log))
    for block in re.split(r"Function : ", sass)[1:]:
        mangled = block.split("\n", 1)[0].strip()
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", block)]
        plain = subprocess.run(["c++filt", mangled], capture_output=True,
                               text=True).stdout.strip()
        plain = plain.replace("(anonymous namespace)::", "")
        print("%s: ptxas %s; %s; SASS highest R%d, %d STL, %d HGMMA, "
              "%d WARPGROUP.DEPBAR" % (
                  re.sub(r"^void ", "", plain.split("(")[0]),
                  "; ".join(ptxas.get(mangled, [])),
                  "wgmma serialised (C7512)" if mangled in serialised
                  else "no C7512",
                  max(regs, default=-1), block.count("STL"),
                  block.count("HGMMA"), block.count("WARPGROUP.DEPBAR")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
