"""HDFS text streaming: a chunked line reader unit over a pluggable
transport.

Port of ``veles_tpu/loader/hdfs.py``: ``HDFSTextLoader`` streams a text
file in chunks of ``chunk`` lines into ``output`` and raises
``finished`` at its end. The transport is a ``reader`` callable when
one is given (tests, local files, pipes); otherwise
:func:`open_hdfs_lines` tries pyarrow's HadoopFileSystem, the ``hdfs``
client and the ``hdfs dfs -cat`` CLI in that order, and raises when
none is present.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Any, Callable, Iterator, Optional

from veles_tpu_torch.distributable import TriviallyDistributable
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit


def _pyarrow_reader(path: str, host: str, port: int) -> Iterator[str]:
    from pyarrow import fs
    hdfs = fs.HadoopFileSystem(host=host, port=port)
    with hdfs.open_input_stream(path) as stream:
        import io
        for line in io.TextIOWrapper(stream, encoding="utf-8"):
            yield line.rstrip("\n")


def _hdfs_client_reader(path: str, host: str, port: int) -> Iterator[str]:
    from hdfs import InsecureClient
    client = InsecureClient("http://%s:%d" % (host, port))
    with client.read(path, encoding="utf-8") as reader:
        for line in reader:
            yield line.rstrip("\n")


def _cli_reader(path: str, host: str, port: int) -> Iterator[str]:
    url = "hdfs://%s:%d%s" % (host, port, path) if host else path
    proc = subprocess.Popen(["hdfs", "dfs", "-cat", url],
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout is not None
    completed = False
    try:
        for line in proc.stdout:
            yield line.rstrip("\n")
        completed = True
    finally:
        # Always reap the child. An early consumer close
        # (GeneratorExit) or a decode error must not leak the pipe fd
        # or a zombie; the rc check only applies to a full read — a
        # SIGPIPE death after deliberate truncation is not an error.
        proc.stdout.close()
        if not completed:
            proc.terminate()
        rc = proc.wait()
        if completed and rc != 0:
            raise IOError("hdfs dfs -cat %s failed rc=%d" % (url, rc))


def open_hdfs_lines(path: str, host: str = "default",
                    port: int = 0) -> Iterator[str]:
    """Best-available transport for ``hdfs://`` line streams."""
    try:
        import pyarrow  # noqa: F401
        return _pyarrow_reader(path, host, port)
    except ImportError:
        pass
    try:
        import hdfs  # noqa: F401
        return _hdfs_client_reader(path, host, port)
    except ImportError:
        pass
    if shutil.which("hdfs"):
        return _cli_reader(path, host, port)
    raise RuntimeError(
        "No HDFS transport available: install pyarrow (with libhdfs) "
        "or the 'hdfs' client, or put the hadoop 'hdfs' CLI on PATH")


class HDFSTextLoader(Unit, TriviallyDistributable):
    """Streams ``file`` line-by-line in chunks of ``chunk`` lines into
    ``output`` (list of str, padded with "" on the final short chunk);
    ``finished`` flips at EOF. ``reader`` overrides the transport with
    any ``() -> Iterator[str]`` (tests; local files; pipes)."""

    MAPPING = "hdfs_text"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.file_name: str = kwargs.pop("file")
        self.chunk_lines_number: int = kwargs.pop("chunk", 1000)
        self.host: str = kwargs.pop("host", "default")
        self.port: int = kwargs.pop("port", 0)
        self._reader_factory: Optional[Callable[[], Iterator[str]]] = \
            kwargs.pop("reader", None)
        super().__init__(workflow, **kwargs)
        self.output = [""] * self.chunk_lines_number
        self.chunk_size = 0            # valid lines in this chunk
        self.finished = Bool(False)

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._generator_ = None

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        if self._reader_factory is not None:
            self._generator_ = iter(self._reader_factory())
        else:
            self._generator_ = open_hdfs_lines(
                self.file_name, self.host, self.port)
        return None

    def run(self) -> None:
        assert not self.finished
        self.chunk_size = 0
        for i in range(self.chunk_lines_number):
            try:
                self.output[i] = next(self._generator_)
                self.chunk_size += 1
            except StopIteration:
                for j in range(i, self.chunk_lines_number):
                    self.output[j] = ""
                self.finished <<= True
                return
