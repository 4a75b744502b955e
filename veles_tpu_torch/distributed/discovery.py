"""Cluster node discovery — the YARN-resource-manager equivalent.

Port of ``veles_tpu/distributed/discovery.py``, sources unchanged.
Reference capability: veles/launcher.py:887-906 asked a YARN RM for
the cluster's node list and ssh-launched one slave per node. The
analogues:

- a **hostfile** (``--nodes @/path``): one host per line, ``#``
  comments, blanks ignored — the openmpi/slurm idiom;
- **TPU-VM / GCE metadata** (``--nodes auto``): the
  ``TPU_WORKER_HOSTNAMES`` env var every multi-host TPU VM carries,
  falling back to the GCE metadata server's
  ``worker-network-endpoints`` attribute (the TPU pod's
  ``uid:ip:port`` list).

``resolve_nodes`` is wired behind ``--nodes``; explicit comma lists
pass through untouched.

**Elastic join beacon**: a live coordinator (``--announce``) runs an
:class:`Announcer` — a UDP datagram broadcast of its address +
workflow checksum every second — and an elastic joiner
(``--join auto``) calls :func:`discover_coordinator` to find it
without any out-of-band address exchange. The beacon is a JSON
datagram on :data:`DEFAULT_ANNOUNCE_PORT` (override via
``VELES_ANNOUNCE_PORT``), sent to the broadcast address and loopback;
joiners filter by checksum when they already know their workflow.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import List, Optional

#: Overridable for tests (and for non-GCE metadata proxies).
METADATA_BASE_ENV = "VELES_GCE_METADATA"
DEFAULT_METADATA_BASE = "http://metadata.google.internal"
_ENDPOINT_PATH = ("/computeMetadata/v1/instance/attributes/"
                  "worker-network-endpoints")


def parse_hostfile(path: str) -> List[str]:
    hosts: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                # slurm/openmpi hostfiles may carry "host slots=N"
                hosts.append(line.split()[0])
    return hosts


def _metadata_endpoints(timeout: float = 2.0) -> Optional[str]:
    """Fetch the TPU pod's worker-network-endpoints attribute, or
    None when there is no metadata server (not on GCE)."""
    import urllib.error
    import urllib.request

    base = os.environ.get(METADATA_BASE_ENV, DEFAULT_METADATA_BASE)
    req = urllib.request.Request(
        base + _ENDPOINT_PATH, headers={"Metadata-Flavor": "Google"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError):
        return None


def discover_tpu_workers() -> List[str]:
    """Worker hostnames of this multi-host TPU slice, from the env the
    TPU runtime provides, else from the metadata server. Empty when
    neither source exists (single host / not a TPU VM)."""
    names = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if names.strip():
        return [h.strip() for h in names.split(",") if h.strip()]
    endpoints = _metadata_endpoints()
    if not endpoints:
        return []
    hosts = []
    for entry in endpoints.strip().split(","):
        # "uid:ip:port" triples (older images: plain "ip:port")
        parts = entry.strip().split(":")
        if len(parts) >= 2:
            hosts.append(parts[-2])
        elif parts and parts[0]:
            hosts.append(parts[0])
    return hosts


#: UDP port the coordinator beacon uses (env: VELES_ANNOUNCE_PORT).
DEFAULT_ANNOUNCE_PORT = 51423
_BEACON_KEY = "veles_tpu_coordinator"


def announce_port(port: Optional[int] = None) -> int:
    if port:
        return int(port)
    return int(os.environ.get("VELES_ANNOUNCE_PORT",
                              DEFAULT_ANNOUNCE_PORT))


class Announcer:
    """Background UDP beacon for a live coordinator or serve replica:
    joiners on the same network (or host) discover the farm — and a
    fleet router discovers its replicas — without being handed an
    address. Datagrams go to the broadcast address and loopback; both
    best-effort — an unreachable target is ignored, the beacon is an
    optimization, never a dependency.

    Beacons are ROLE-TAGGED (``role=coordinator|replica``): a serve
    fleet and a training farm sharing one LAN announce on the same
    UDP port, and an elastic ``--join auto`` worker dialing a serve
    replica (or a router adding a training coordinator as a
    "replica") would fail confusingly late — so
    :func:`discover_coordinator` and :func:`discover_replicas` each
    filter to their own role. Replica beacons carry the SERVE address
    (``serve_port`` rides the payload explicitly too)."""

    def __init__(self, address: str, checksum: str,
                 port: Optional[int] = None, interval: float = 1.0,
                 targets: Optional[List[str]] = None,
                 threads=None, role: str = "coordinator") -> None:
        host, tcp_port = address.rsplit(":", 1) if ":" in address \
            else (address, "0")
        if host in ("", "0.0.0.0"):
            # a wildcard bind is unreachable as a dial target; the
            # best loopback-safe default is this host's name
            host = socket.gethostname()
        if role not in ("coordinator", "replica"):
            raise ValueError("role must be 'coordinator' or "
                             "'replica', got %r" % (role,))
        self.role = role
        self.payload = json.dumps({
            _BEACON_KEY: "%s:%s" % (host, tcp_port),
            "checksum": checksum,
            "role": role,
            "serve_port": int(tcp_port) if role == "replica" else None,
        }).encode()
        self.port = announce_port(port)
        self.interval = interval
        self.targets = list(targets) if targets is not None else \
            ["<broadcast>", "127.0.0.1"]
        self._stop = threading.Event()
        self._threads = threads
        self._thread = None

    def start(self) -> None:
        if self._threads is not None:
            self._thread = self._threads.spawn(self._loop,
                                               name="announcer")
        else:
            from veles_tpu_torch.thread_pool import ManagedThreads
            self._threads = ManagedThreads(name="announcer")
            self._own_threads = True
            self._thread = self._threads.spawn(self._loop,
                                               name="announcer")

    def _loop(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        except OSError:
            pass
        try:
            while not self._stop.is_set():
                for target in self.targets:
                    try:
                        sock.sendto(self.payload, (target, self.port))
                    except OSError:
                        pass  # e.g. no broadcast route in a container
                self._stop.wait(self.interval)
        finally:
            sock.close()

    def stop(self) -> None:
        self._stop.set()
        if getattr(self, "_own_threads", False):
            self._threads.join_all(timeout=5)


def _beacon_socket(port: Optional[int]) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError):
        pass
    sock.bind(("", announce_port(port)))
    return sock


def _matching_beacon(datagram: bytes, role: str,
                     checksum: Optional[str]) -> Optional[str]:
    """Beacon address when the datagram is a well-formed beacon of
    ``role`` (legacy beacons carry no role key and count as
    coordinators — every pre-role announcer WAS one) matching the
    optional checksum filter; None otherwise."""
    try:
        beacon = json.loads(datagram.decode("utf-8", "replace"))
    except ValueError:
        return None
    if not isinstance(beacon, dict):
        return None
    address = beacon.get(_BEACON_KEY)
    if not address:
        return None
    if beacon.get("role", "coordinator") != role:
        return None
    if checksum is not None and beacon.get("checksum") != checksum:
        return None
    return address


def discover_coordinator(timeout: float = 5.0,
                         port: Optional[int] = None,
                         checksum: Optional[str] = None
                         ) -> Optional[str]:
    """Listen for one coordinator beacon; returns ``ADDR:PORT`` or
    None after ``timeout``. ``checksum`` filters to a specific
    workflow's farm when several coordinators announce. Replica
    beacons (a serve fleet on the same LAN/port) never match — a
    worker must not dial an HTTP front as its coordinator."""
    sock = _beacon_socket(port)
    try:
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            sock.settimeout(remaining)
            try:
                datagram, _ = sock.recvfrom(4096)
            except socket.timeout:
                return None
            address = _matching_beacon(datagram, "coordinator",
                                       checksum)
            if address is not None:
                return address
    finally:
        sock.close()


def _dialable(address: str) -> bool:
    """True when a beacon address is a ``host:port`` a router could
    actually dial — an unauthenticated UDP datagram must not be able
    to plant junk in (or crash) a consumer."""
    host, sep, port = address.rpartition(":")
    return bool(sep) and bool(host) and port.isdigit() and \
        0 < int(port) < 65536


def discover_replicas(timeout: float = 2.0,
                      port: Optional[int] = None,
                      checksum: Optional[str] = None,
                      expect: Optional[int] = None) -> List[str]:
    """Collect serve-replica beacon addresses (``role=replica``) for
    the full ``timeout`` window — the fleet router's replica-
    discovery plane. Deduplicates and drops non-dialable addresses
    (junk-safe: anyone can send a UDP datagram); returns as soon as
    ``expect`` distinct replicas were heard (None = listen out the
    window). Coordinator beacons on the same port never match."""
    sock = _beacon_socket(port)
    found: List[str] = []
    try:
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return found
            sock.settimeout(remaining)
            try:
                datagram, _ = sock.recvfrom(4096)
            except socket.timeout:
                return found
            address = _matching_beacon(datagram, "replica", checksum)
            if address is not None and _dialable(address) and \
                    address not in found:
                found.append(address)
                if expect is not None and len(found) >= expect:
                    return found
    finally:
        sock.close()


def resolve_nodes(spec: Optional[str]) -> Optional[List[str]]:
    """``--nodes`` value -> host list.

    - ``None``/empty -> None (all workers local);
    - ``@path`` or ``hostfile:path`` -> :func:`parse_hostfile`;
    - ``auto`` -> :func:`discover_tpu_workers` (error if none found);
    - anything else -> comma-separated literal list.
    """
    if not spec:
        return None
    if spec.startswith("@"):
        return parse_hostfile(spec[1:])
    if spec.startswith("hostfile:"):
        return parse_hostfile(spec.split(":", 1)[1])
    if spec == "auto":
        hosts = discover_tpu_workers()
        if not hosts:
            raise SystemExit(
                "--nodes auto: no TPU_WORKER_HOSTNAMES and no GCE "
                "metadata server — pass hosts explicitly or via "
                "--nodes @hostfile")
        return hosts
    return [h.strip() for h in spec.split(",")]
