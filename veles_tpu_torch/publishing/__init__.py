"""End-of-training report publishing (port of ``veles_tpu/publishing``;
reference: veles/publishing/)."""

from veles_tpu_torch.publishing.publisher import (BACKENDS, Publisher,  # noqa: F401
                                            publish_confluence,
                                            render_report)
