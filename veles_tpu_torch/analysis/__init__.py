"""Analysis of the port: the workflow graph verifier
(:mod:`veles_tpu_torch.analysis.graph`) and the capture counter
(:mod:`veles_tpu_torch.analysis.recompile`)."""
