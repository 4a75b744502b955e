"""Serving plane of the port: the slab and paged generative engines,
the page pool, the continuous token batcher, the model registry and
the HTTP front."""

from veles_tpu_torch.serve.batcher import (DeadlineExceeded, Draining,  # noqa: F401
                                           GenMetrics, NonFiniteLogits,
                                           QueueFull, TokenBatcher)
from veles_tpu_torch.serve.engine import (GenerativeEngine,  # noqa: F401
                                          PagedGenerativeEngine,
                                          bucket_for)
from veles_tpu_torch.serve.paging import PagePool, PagesExhausted  # noqa: F401
from veles_tpu_torch.serve.registry import ModelRegistry  # noqa: F401
from veles_tpu_torch.serve.server import ServeServer  # noqa: F401
