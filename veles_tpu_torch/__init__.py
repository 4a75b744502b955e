"""veles_tpu_torch: the PyTorch and CUDA port of veles_tpu for one
NVIDIA H100.

The JAX package ``veles_tpu`` stays the reference; this package
imports ``torch`` and ``numpy`` and nothing of JAX or of
``veles_tpu``. Module paths mirror the reference's, so each port has
its counterpart at the same path (``veles_tpu/serve/engine.py`` <->
``veles_tpu_torch/serve/engine.py``). The first slice serves the
transformer LM: prefill and slab decode, with the flash forward and
decode kernels written in CUDA C++ (``ops/csrc``).

Entry points run on the current CUDA device unless the caller passes
``device="cpu"`` (:mod:`veles_tpu_torch.device`).
"""
