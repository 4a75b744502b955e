"""Wire-format tests of the port's farm protocol
(``veles_tpu_torch.distributed.protocol``): the JAX package's
``tests/test_protocol.py`` cases (zero-copy protocol-5 frames (v2),
legacy (v1) interop and rejection, probe-gated per-buffer compression,
per-connection wire stats, the concurrent-send frame-integrity lock),
and frames that cross between the two packages' ``Connection`` in both
directions."""

import socket
import threading

import numpy as np
import pytest

import veles_tpu.distributed.protocol as R_protocol
from veles_tpu_torch.distributed.protocol import (HEADER, MAGIC, MAGIC2,
                                                  Connection, Frame)


def _pair():
    a, b = socket.socketpair()
    return Connection(a), Connection(b)


def _send_bg(conn, *objs):
    """Send from a background thread: payloads larger than the
    socketpair buffer would deadlock a same-thread send-then-recv."""
    def run():
        for obj in objs:
            conn.send(obj)
    t = threading.Thread(target=run)
    t.start()
    return t


def _close(*conns):
    for conn in conns:
        conn.close()


# -- zero-copy v2 frames ----------------------------------------------------
def test_v2_roundtrip_zero_copy_out_of_band():
    """Parameter arrays travel as out-of-band buffers: buffer_callback
    fired, the array bytes are ABSENT from the pickle stream, and the
    stream stays control-sized regardless of blob size."""
    params = np.random.default_rng(0).standard_normal(
        (256, 1024)).astype(np.float32)
    indices = np.arange(500, dtype=np.int32)
    obj = {"type": "job", "job_id": 7,
           "data": {"params": params, "indices": indices, "note": "x"}}
    segments, n_oob, raw = Frame.encode_segments(obj, wire_version=2)
    assert n_oob >= 2  # params + indices left the stream
    head, stream = bytes(segments[0]), bytes(segments[1])
    assert head[:4] == MAGIC2
    # the pickle stream is control traffic only: a 1 MiB blob must not
    # be copied through it
    assert len(stream) < 4096
    assert params.tobytes()[:64] not in stream
    assert raw >= params.nbytes + indices.nbytes

    sender, receiver = _pair()
    try:
        t = _send_bg(sender, obj)
        got = receiver.recv(timeout=10.0)
        t.join(timeout=10)
        np.testing.assert_array_equal(got["data"]["params"], params)
        np.testing.assert_array_equal(got["data"]["indices"], indices)
        assert got["data"]["note"] == "x"
        assert sender.stats.oob_buffers_out >= 2
        assert receiver.stats.oob_buffers_in == sender.stats.oob_buffers_out
        assert sender.stats.frames_out == receiver.stats.frames_in == 1
        assert sender.stats.bytes_out == receiver.stats.bytes_in
        # zero-copy bound: wire bytes ~= payload bytes, not 2x
        assert sender.stats.bytes_out < params.nbytes + \
            indices.nbytes + 8192
    finally:
        _close(sender, receiver)


def test_v2_float_blobs_never_compressed():
    """The probe rejects raw float weights (gzip ratio ~1.0): they ship
    verbatim instead of paying a futile compress."""
    params = np.random.default_rng(1).standard_normal(
        1 << 18).astype(np.float32)
    sender, receiver = _pair()
    try:
        t = _send_bg(sender, {"params": params})
        got = receiver.recv(timeout=10.0)
        t.join(timeout=10)
        np.testing.assert_array_equal(got["params"], params)
        # incompressible blob shipped raw: wire ~= logical
        assert sender.stats.compression_ratio > 0.95
    finally:
        _close(sender, receiver)


def test_v2_compressible_buffers_do_shrink():
    """Buffers that actually shrink (zeros, index runs) are gzipped."""
    zeros = np.zeros(1 << 18, dtype=np.float32)
    sender, receiver = _pair()
    try:
        sender.send({"z": zeros})
        got = receiver.recv(timeout=10.0)
        np.testing.assert_array_equal(got["z"], zeros)
        assert sender.stats.compression_ratio < 0.05
        assert sender.stats.bytes_out < zeros.nbytes // 10
    finally:
        _close(sender, receiver)


def test_v2_received_arrays_are_writable():
    """Out-of-band buffers land in fresh bytearrays: reconstructed
    arrays are private and writable (no readonly surprises for units
    that update weights in place)."""
    sender, receiver = _pair()
    try:
        sender.send({"w": np.ones(1024, dtype=np.float32)})
        got = receiver.recv(timeout=10.0)
        got["w"][0] = 5.0  # must not raise
        assert got["w"][0] == 5.0
    finally:
        _close(sender, receiver)


# -- interop / rejection ----------------------------------------------------
def test_v1_sender_understood_by_v2_receiver():
    a, b = socket.socketpair()
    sender = Connection(a, wire_version=1)
    receiver = Connection(b)  # v2 default: dual-version receive
    try:
        payload = {"type": "job", "data": np.arange(10000)}
        sender.send(payload)
        got = receiver.recv(timeout=10.0)
        np.testing.assert_array_equal(got["data"], payload["data"])
        assert receiver.stats.oob_buffers_in == 0  # came in-band
    finally:
        _close(sender, receiver)


def test_legacy_frame_encode_still_decodes():
    """The retained single-buffer Frame.encode produces v1 frames a
    Connection can still receive (old->new interop)."""
    blob = Frame.encode({"x": 1, "big": b"a" * 4096})
    assert blob[:4] == MAGIC
    a, b = socket.socketpair()
    receiver = Connection(b)
    try:
        a.sendall(blob)
        got = receiver.recv(timeout=10.0)
        assert got == {"x": 1, "big": b"a" * 4096}
    finally:
        a.close()
        receiver.close()


def test_v2_frame_rejected_by_legacy_decoder():
    """A v1-only peer rejects a v2 frame with a clean error on the
    magic, not a stream desync."""
    segments, _, _ = Frame.encode_segments(
        {"params": np.ones(100, np.float32)}, wire_version=2)
    head = bytes(segments[0])
    with pytest.raises(ConnectionError, match="bad frame magic"):
        Frame.decode_header(head[:HEADER.size])


def test_unknown_magic_rejected_by_connection():
    a, b = socket.socketpair()
    receiver = Connection(b)
    try:
        a.sendall(b"XXXX" + b"\x00" * 16)
        with pytest.raises(ConnectionError, match="bad frame magic"):
            receiver.recv(timeout=10.0)
    finally:
        a.close()
        receiver.close()


def test_probe_false_skips_per_buffer_probe_and_ships_raw():
    """``send(probe=False)`` (the codec path): out-of-band buffers
    skip the gzip probe entirely — even compressible ones ship raw —
    so quantized int8/bf16 payloads never pay a 64 KiB probe per
    send."""
    from unittest import mock

    import veles_tpu_torch.distributed.protocol as protocol

    zeros = np.zeros(1 << 18, dtype=np.float32)  # maximally probeable
    calls = []
    real = protocol._probe_compressible

    def counting(view):
        calls.append(len(view))
        return real(view)

    sender, receiver = _pair()
    try:
        with mock.patch.object(protocol, "_probe_compressible",
                               counting):
            t = _send_bg(sender, {"z": zeros})  # default: probed+gzip
            receiver.recv(timeout=10.0)
            t.join(timeout=10)
            assert calls, "default send must probe"
            calls.clear()
            before = sender.stats.bytes_out
            t2 = _send_bg_probe_false(sender, {"z": zeros})
            got = receiver.recv(timeout=10.0)
            t2.join(timeout=10)
            np.testing.assert_array_equal(got["z"], zeros)
            assert not calls, "probe=False must never probe"
            # and the buffer really shipped raw (no gzip shrink)
            assert sender.stats.bytes_out - before >= zeros.nbytes
    finally:
        _close(sender, receiver)


def _send_bg_probe_false(conn, obj):
    def run():
        conn.send(obj, probe=False)
    t = threading.Thread(target=run)
    t.start()
    return t


def test_control_pickle_still_compressed_when_it_shrinks():
    """v2 keeps gzip for the control pickle itself when it wins (e.g.
    repetitive non-buffer payloads)."""
    sender, receiver = _pair()
    try:
        sender.send({"log": "spam " * 10000})
        got = receiver.recv(timeout=10.0)
        assert got["log"].startswith("spam ")
        assert sender.stats.compression_ratio < 0.1
    finally:
        _close(sender, receiver)


# -- concurrency ------------------------------------------------------------
def test_concurrent_senders_do_not_corrupt_frames():
    """Regression for the handler/producer send race: two threads
    hammering one Connection must interleave only at FRAME granularity.
    Without the per-connection send lock the scatter writes shear and
    the receiver desyncs on a bad magic."""
    sender, receiver = _pair()
    n_each = 150
    # big enough that an unlocked write is practically guaranteed to
    # be split across multiple socket writes
    blob = np.random.default_rng(2).standard_normal(1 << 16)
    errors = []

    def hammer(who):
        try:
            for seq in range(n_each):
                sender.send({"who": who, "seq": seq, "blob": blob})
        except Exception as e:  # pragma: no cover
            errors.append(repr(e))

    threads = [threading.Thread(target=hammer, args=(who,))
               for who in ("a", "b")]
    try:
        for t in threads:
            t.start()
        seen = {"a": [], "b": []}
        for _ in range(2 * n_each):
            msg = receiver.recv(timeout=30.0)
            np.testing.assert_array_equal(msg["blob"], blob)
            seen[msg["who"]].append(msg["seq"])
        assert not errors, errors
        # per-sender order is preserved even under interleaving
        assert seen["a"] == list(range(n_each))
        assert seen["b"] == list(range(n_each))
    finally:
        for t in threads:
            t.join(timeout=15)
        _close(sender, receiver)


def test_wire_stats_track_both_directions():
    sender, receiver = _pair()
    try:
        sender.send({"params": np.ones(4096, np.float32)})
        receiver.recv(timeout=10.0)
        receiver.send({"type": "update_ack"})
        sender.recv(timeout=10.0)
        for stats in (sender.stats, receiver.stats):
            assert stats.frames_out == stats.frames_in == 1
            assert stats.bytes_out > 0 and stats.bytes_in > 0
            assert stats.serialize_seconds >= 0.0
            assert stats.deserialize_seconds >= 0.0
        d = sender.stats.as_dict()
        assert {"bytes_in", "bytes_out", "compression_ratio",
                "oob_buffers_out"} <= set(d)
    finally:
        _close(sender, receiver)


# -- interop with the JAX package's Connection ------------------------------
def _interop_payload():
    rng = np.random.default_rng(3)
    return {"type": "update", "id": 7, "wid": "w0001",
            "data": {"fc1": {"weights": rng.standard_normal(
                (64, 33)).astype(np.float32),
                "bias": np.zeros(33, np.float32)},
                "loader": {"indices": np.arange(50, dtype=np.int64),
                           "epoch": 2}},
            "note": "x" * 3000, "ratio": 0.25, "flags": [True, None]}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("wire_version", [1, 2])
@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_frames_cross_between_the_packages(direction, wire_version):
    """A frame of plain dicts and numpy arrays sent by one package's
    Connection is received intact by the other's (v1 and v2 frames,
    gzip-compressed control pickle included)."""
    a, b = socket.socketpair()
    if direction == "port_to_reference":
        sender, receiver = Connection(a), R_protocol.Connection(b)
    else:
        sender, receiver = R_protocol.Connection(a), Connection(b)
    sender.wire_version = wire_version
    payload = _interop_payload()
    try:
        t = _send_bg(sender, payload, {"type": "bye"})
        _assert_same(receiver.recv(timeout=10.0), payload)
        assert receiver.recv(timeout=10.0) == {"type": "bye"}
        t.join(timeout=10)
    finally:
        _close(sender, receiver)


def test_frame_segments_are_the_references_bytes():
    """The two packages encode the same message into the same bytes,
    segment for segment, in both wire versions."""
    payload = _interop_payload()
    for version in (1, 2):
        got, _, _ = Frame.encode_segments(payload, wire_version=version)
        want, _, _ = R_protocol.Frame.encode_segments(
            payload, wire_version=version)
        assert [bytes(x) for x in got] == [bytes(x) for x in want]
