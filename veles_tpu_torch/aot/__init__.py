"""The AOT plane of the port: package archives, capture records and the
persistent cache behind a second-scale cold start.

Port of ``veles_tpu/aot``:

- :mod:`veles_tpu_torch.aot.package`: package-archive I/O, one checked
  extraction per archive;
- :mod:`veles_tpu_torch.aot.export`: fingerprints, the self-validating
  blob and the capture record (the counterpart of an exported
  computation: a captured CUDA graph cannot be serialized);
- :mod:`veles_tpu_torch.aot.cache`: ``DIR/kernels/`` (kernel libraries,
  the compile layer) and ``DIR/artifacts/`` (capture records);
- :mod:`veles_tpu_torch.aot.warmup`: the process's :class:`Plan`, warm
  ladders and the startup report;
- :mod:`veles_tpu_torch.aot.registry`: every capture site on canonical
  configs.
"""

from veles_tpu_torch.aot.cache import ArtifactCache, configure_kernel_cache
from veles_tpu_torch.aot.export import (AotUnavailable, fingerprint,
                                        pack_record, unpack_record)
from veles_tpu_torch.aot.warmup import (Bundle, Plan, active, configure,
                                        deactivate, flush_export,
                                        read_bundle, startup_report,
                                        status_doc, warm_engine)

__all__ = [
    "AotUnavailable", "ArtifactCache", "Bundle", "Plan", "active",
    "configure", "configure_kernel_cache", "deactivate", "fingerprint",
    "flush_export", "pack_record", "read_bundle", "startup_report",
    "status_doc", "unpack_record", "warm_engine",
]
