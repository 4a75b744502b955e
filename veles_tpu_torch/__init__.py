"""veles_tpu_torch: the PyTorch and CUDA port of veles_tpu for one
NVIDIA H100.

The JAX package ``veles_tpu`` stays the reference; this package
imports ``torch`` and ``numpy`` and nothing of JAX or of
``veles_tpu``. Module paths mirror the reference's, so each port has
its counterpart at the same path (``veles_tpu/serve/engine.py`` <->
``veles_tpu_torch/serve/engine.py``). It serves and trains the
transformer LM and the AlexNet classifier with the reference's Pallas
kernels written in CUDA C++ (``ops/csrc``), shares one card among
tenants (:mod:`veles_tpu_torch.sched`) and carries the reference's
unit graph (``units``, ``workflow``, ``accelerated_units``, ...).

Entry points run on the current CUDA device unless the caller passes
``device="cpu"`` (:mod:`veles_tpu_torch.device`; ``Device()`` of
:mod:`veles_tpu_torch.backends` alike, with ``Device(backend="cpu")``).
"""
