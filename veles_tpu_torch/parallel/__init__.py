"""Parallel training of the port: the fused classifier trainer, the mesh
over ``torch.distributed`` and its collectives, the multi-process join,
ring attention and the GPipe pipeline."""
