"""Host-level distributed control plane: the training farm.

Port of ``veles_tpu/distributed/``. The reference architecture
(SURVEY.md §2.3): a Twisted TCP control channel + a ZeroMQ data
channel, per-slave FSMs, dynamic minibatch job farming, elastic
membership, drop/requeue/blacklist/adaptive-timeout/respawn,
``--slave-death-probability`` fault injection (veles/server.py,
veles/client.py, veles/txzmq/).

Gradient traffic of a mesh never touches this layer: it rides the
mesh's collectives (``veles_tpu_torch.parallel``). What stays on the
host is what the reference's control plane did: job scheduling
(minibatch index slices, GA chromosomes, ensemble model indices),
elastic worker membership, failure detection and requeue, over a
length-prefixed pickle protocol on stdlib sockets and threads (control
rate, not bandwidth rate). Job payloads are the host numpy arrays the
workflows' job methods return; the frames, codecs and handshakes are
the reference's byte for byte, so a port peer and a reference peer
read each other's frames.
"""

from veles_tpu_torch.distributed.protocol import (  # noqa: F401
    Connection, Frame, checksum_handshake)
from veles_tpu_torch.distributed.server import (  # noqa: F401
    Coordinator, resume_farm, run_coordinator)
from veles_tpu_torch.distributed.client import (  # noqa: F401
    Worker, run_worker)
from veles_tpu_torch.distributed.spawn import (  # noqa: F401
    WorkerPool, worker_argv)

# NOTE: veles_tpu_torch.distributed.relay is deliberately NOT imported
# here: it is a `python -m veles_tpu_torch.distributed.relay` entry
# point, and an eager package-level import would make runpy warn about
# (and re-execute) the already-imported module. Import it directly:
#   from veles_tpu_torch.distributed.relay import Relay
