#!/bin/bash
# The wall time of each kernel source's nvcc, all started at once as
# veles_tpu_torch/ops/_build.py starts them, on the machine with the
# card (nvcc under /usr/local/cuda):
#
#     bash scripts/torch_nvcc_times.sh [CSRC_DIR] [EXTRA_FLAGS...]
#
# CSRC_DIR (default veles_tpu_torch/ops/csrc) holds the .cu and .cuh
# files, e.g. a parent checkout's; EXTRA_FLAGS are added to the build's
# own flags less -split-compile=0 (e.g. -split-compile=0 to time it).
# Prints one line a source: "nvcc <source> <seconds> s <ok|FAIL>".
set -u
CSRC=${1:-veles_tpu_torch/ops/csrc}
shift || true
NVCC=${NVCC:-/usr/local/cuda/bin/nvcc}
OUT=$(mktemp -d)
trap 'rm -rf "$OUT"' EXIT
TIMEFORMAT="%R"
for cu in "$CSRC"/*.cu; do
  name=$(basename "$cu" .cu)
  (
    t=$( { time "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 \
             -O3 "$@" -shared -Xcompiler -fPIC -Xptxas -v \
             -o "$OUT/$name.so" "$cu" > "$OUT/$name.log" 2>&1; } 2>&1 )
    status=FAIL
    [ -s "$OUT/$name.so" ] && status=ok
    echo "nvcc $name $t s $status"
  ) &
done
wait
