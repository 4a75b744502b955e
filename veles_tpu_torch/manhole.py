"""Manhole: attach a live REPL to a running (possibly hung) process
(port of ``veles_tpu/manhole.py``).

Reference capability: veles/external/manhole.py (vendored) wired in by
veles/thread_pool.py:139-143 — ``--manhole`` opened a unix-socket REPL
named after the pid so an operator could inspect a wedged master/slave.
Here: ``install()`` binds ``$TMPDIR/veles_tpu_torch.manhole.<pid>``
(``/tmp`` by default; the port's own name, apart from the reference's) and serves a
``code.InteractiveConsole`` per connection in a daemon thread (``socat
- unix-connect:/tmp/veles_tpu_torch.manhole.<pid>`` or ``python -m
veles_tpu_torch.manhole <pid>`` to attach). SIGUSR2 additionally dumps
every thread's stack to stderr — the "is it hung and where" one-shot
that needs no attach at all; :meth:`Manhole.close` puts back the
SIGUSR2 handler that ``install`` replaced.
"""

from __future__ import annotations

import code
import io
import os
import signal
import socket
import sys
import tempfile
import threading
import traceback
from typing import Any, Dict, Optional

#: the socket's path by pid: under the temporary directory, named apart
#: from the reference's ``veles_tpu.manhole.<pid>``
_SOCKET_TEMPLATE = os.path.join(tempfile.gettempdir(),
                                "veles_tpu_torch.manhole.%d")
_installed: Optional["Manhole"] = None


def dump_threads(file=None) -> str:
    """Every thread's stack, newest frame last (reference: manhole's
    stack-dump-on-connect)."""
    out = io.StringIO()
    frames = sys._current_frames()
    for thread in threading.enumerate():
        frame = frames.get(thread.ident)
        out.write("\n--- %s (%sdaemon, ident %s)\n" %
                  (thread.name, "" if thread.daemon else "non-",
                   thread.ident))
        if frame is not None:
            traceback.print_stack(frame, file=out)
    text = out.getvalue()
    print(text, file=file or sys.stderr)
    return text


class _SocketConsole(code.InteractiveConsole):
    def __init__(self, conn: socket.socket,
                 local_ns: Dict[str, Any]) -> None:
        super().__init__(locals=local_ns)
        # Separate reader and writer: one "rw" TextIOWrapper silently
        # DISCARDS its buffered read-ahead on every interleaved write,
        # so the second of two command lines arriving in one packet
        # was lost and the console hung in readline() forever.
        self._reader = conn.makefile("r")
        self._file = conn.makefile("w")

    def write(self, data: str) -> None:
        try:
            self._file.write(data)
            self._file.flush()
        except (OSError, ValueError):
            raise SystemExit

    def runcode(self, codeobj) -> None:
        # print()/displayhook go to the process stdout by default;
        # route them to the attached terminal for the duration of the
        # command (process-global but command-scoped — the same trade
        # the reference manhole made by redirecting stdio).
        import contextlib
        try:
            with contextlib.redirect_stdout(self._file):
                super().runcode(codeobj)
            self._file.flush()
        except (OSError, ValueError):
            raise SystemExit

    def raw_input(self, prompt: str = "") -> str:
        self.write(prompt)
        try:
            line = self._reader.readline()
        except (OSError, ValueError):
            raise EOFError
        if not line:
            raise EOFError
        return line.rstrip("\n")


class Manhole:
    """Unix-socket REPL server; one console thread per connection."""

    def __init__(self, path: Optional[str] = None,
                 namespace: Optional[Dict[str, Any]] = None) -> None:
        self.path = path or _SOCKET_TEMPLATE % os.getpid()
        self.namespace = dict(namespace or {})
        #: the SIGUSR2 handler ``install`` replaced (restored by close)
        self._prev_sigusr2: Any = None
        self._owns_signal = False
        self.namespace.setdefault("dump_threads", dump_threads)
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._listener = socket.socket(socket.AF_UNIX,
                                       socket.SOCK_STREAM)
        self._listener.bind(self.path)
        os.chmod(self.path, 0o600)  # owner-only: this is an exec door
        self._listener.listen(2)
        # Daemon is correct here: the manhole is a door INTO a possibly
        # hung process — its threads must never keep that process alive.
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="manhole", daemon=True)  # noqa: VL003
        self._thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             name="manhole-repl", daemon=True).start()  # noqa: VL003 — REPL must not block exit

    def _serve(self, conn: socket.socket) -> None:
        ns = dict(self.namespace)
        console = _SocketConsole(conn, ns)
        try:
            console.interact(
                banner="veles_tpu_torch manhole (pid %d) — dump_threads() "
                       "prints all stacks; Ctrl-D detaches" %
                       os.getpid(),
                exitmsg="detached")
        except (SystemExit, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close the socket, remove its file and put back the SIGUSR2
        handler ``install`` replaced; the next ``install`` opens anew."""
        global _installed
        try:
            self._listener.close()
        finally:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
            if self._owns_signal and threading.current_thread() is \
                    threading.main_thread():
                signal.signal(signal.SIGUSR2, self._prev_sigusr2)
                self._owns_signal = False
            if _installed is self:
                _installed = None


def install(namespace: Optional[Dict[str, Any]] = None,
            with_signal: bool = True) -> Manhole:
    """Idempotent process-wide install; returns the Manhole. With
    ``with_signal`` SIGUSR2 dumps all thread stacks to stderr."""
    global _installed
    if _installed is None:
        _installed = Manhole(namespace=namespace)
        if with_signal and threading.current_thread() is \
                threading.main_thread():
            _installed._prev_sigusr2 = signal.signal(
                signal.SIGUSR2, lambda signum, frame: dump_threads())
            _installed._owns_signal = True
    elif namespace:
        _installed.namespace.update(namespace)
    return _installed


def connect(pid: int) -> None:
    """Interactive client: bridge this terminal to the target's REPL
    (``python -m veles_tpu_torch.manhole <pid>``)."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(_SOCKET_TEMPLATE % pid)
    file = sock.makefile("rw")

    def pump_out():
        while True:
            data = sock.recv(4096)
            if not data:
                return
            sys.stdout.write(data.decode(errors="replace"))
            sys.stdout.flush()

    threading.Thread(target=pump_out, daemon=True).start()  # noqa: VL003 — client-side pump, dies with the CLI
    try:
        for line in sys.stdin:
            file.write(line)
            file.flush()
    except (KeyboardInterrupt, BrokenPipeError):
        pass
    finally:
        sock.close()


if __name__ == "__main__":
    connect(int(sys.argv[1]))
