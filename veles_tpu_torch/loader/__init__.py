"""Data-loading stack: the loader base, the full-batch loaders and the
synthetic datasets (port of ``veles_tpu/loader/``; the other loaders
are listed in ROADMAP.md queue 1 item 5)."""

from veles_tpu_torch.loader.base import (CLASS_NAME, TEST, TRAIN,  # noqa: F401
                                         VALID, ILoader, Loader,
                                         UserLoaderRegistry)
from veles_tpu_torch.loader.fullbatch import (FullBatchLoader,  # noqa: F401
                                              FullBatchLoaderMSE)
