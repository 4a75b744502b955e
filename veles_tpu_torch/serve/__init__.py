"""Serving plane of the port: the forward engine and its
micro-batcher (``POST /apply``), the slab and paged generative
engines, the page pool and the continuous token batcher (``POST
/generate``), the model registry and the HTTP front."""

from veles_tpu_torch.serve.batcher import (DeadlineExceeded, Draining,  # noqa: F401
                                           GenMetrics, MicroBatcher,
                                           NonFiniteLogits,
                                           PoisonedRequest, QueueFull,
                                           ServeMetrics, Shed,
                                           TokenBatcher)
from veles_tpu_torch.serve.engine import (GenerativeEngine,  # noqa: F401
                                          InferenceEngine,
                                          PagedGenerativeEngine,
                                          bucket_for)
from veles_tpu_torch.serve.paging import PagePool, PagesExhausted  # noqa: F401
from veles_tpu_torch.serve.registry import ModelRegistry  # noqa: F401
from veles_tpu_torch.serve.server import ServeServer  # noqa: F401
