"""Forge: the model-hub service (port of ``veles_tpu/forge``; reference:
veles/forge/). Host code only: the server and the client start no CUDA
context."""

from veles_tpu_torch.forge.client import (ForgeClient, pack_package,  # noqa: F401
                                    unpack_package)
from veles_tpu_torch.forge.server import ForgeServer  # noqa: F401
