"""Static analysis of the port: the workflow graph verifier
(:mod:`veles_tpu_torch.analysis.graph`)."""
