"""Update compression codec: bf16 and int8-delta encodings with
per-worker error-feedback residuals.

Port of ``veles_tpu/distributed/compress.py``: numpy on the host
numpy arrays that the workflows' job methods return, so the payloads
and scales are bitwise the reference's on the same arrays.

Reference technique: 1-bit SGD with error feedback (Seide et al.,
2014) and Deep Gradient Compression (Lin et al., 2018) — quantization
error is accumulated locally and folded into the next transmission, so
the receiver's reconstruction *tracks* the sender's true state instead
of drifting. The farm's update payloads are full parameter state with
replacement semantics (not gradients), so the natural delta is
*successive-state* delta: the sender keeps a float32 mirror of exactly
what the receiver has decoded so far and quantizes ``x - mirror``; the
mirror advances by the *quantized* delta on both sides, which makes
error feedback implicit — the next delta automatically contains the
previous step's quantization error.

Encodings (negotiated per connection at HELLO, see
:func:`negotiate`):

``none``
    Identity. The tree passes through untouched (same objects), so the
    wire path stays bitwise-identical to the uncompressed farm.
``bf16``
    Round-to-nearest-even truncation of float32 to bfloat16 (shipped
    as uint16 payloads, 2x fewer bytes). Stateless decode; the sender
    keeps a per-array residual so repeated sends average out the
    rounding error.
``int8``
    Successive-state delta quantized to int8 with one per-array scale
    (``max|delta| / 127``, 4x fewer bytes). The first transmission of
    each array is a keyframe: ``keyframe="f32"`` ships it as raw
    float32 (used coordinator->worker, so a joiner's bootstrap params
    are exact), ``keyframe="quant"`` ships it as an int8 delta from a
    zero mirror (used worker->coordinator, where error feedback
    absorbs the keyframe's quantization error on the next update and
    the whole stream stays at 1 byte/element).

Only float32 ndarrays with at least :data:`MIN_CODE_ELEMS` elements
are coded — control payloads (index slices, counters, scalars) pass
through the normal pickle path untouched. Coded payloads travel as
:class:`CodedArray` markers whose numpy payload rides the wire-v2
out-of-band buffer path; senders disable the per-buffer gzip probe
(``Connection.send(..., probe=False)``) because quantized residual
streams are incompressible by construction.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

#: Encodings this build understands, in preference order.
SUPPORTED = ("int8", "bf16", "none")

#: Arrays smaller than this many elements ship raw — the marker +
#: state overhead would exceed the saving.
MIN_CODE_ELEMS = 256


def negotiate(preferred: Optional[str],
              offered: Optional[Iterable[str]]) -> str:
    """Coordinator-side pick: its configured ``preferred`` encoding
    when the worker's HELLO ``encodings`` list offers it, else
    ``none`` — an old worker that sends no list (or an empty one)
    interops transparently at full precision."""
    if preferred and preferred != "none" and \
            preferred in tuple(offered or ()):
        return preferred
    return "none"


class CodedArray:
    """Wire marker for one coded float32 array. ``payload`` is a numpy
    array (float32 / int8 / uint16) that leaves the pickle stream as a
    protocol-5 out-of-band buffer; ``scale`` rides in the (tiny)
    pickle stream itself so an int8 payload is exactly 1 byte per
    element on the wire."""

    __slots__ = ("kind", "shape", "scale", "payload")

    def __init__(self, kind: str, shape: Tuple[int, ...], scale: float,
                 payload: np.ndarray) -> None:
        self.kind = kind
        self.shape = shape
        self.scale = scale
        self.payload = payload

    def __reduce__(self):
        return (CodedArray,
                (self.kind, self.shape, self.scale, self.payload))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "CodedArray(%s, %s, scale=%g)" % (
            self.kind, self.shape, self.scale)


def _eligible(value: Any) -> bool:
    return (isinstance(value, np.ndarray) and
            value.dtype == np.float32 and
            value.size >= MIN_CODE_ELEMS)


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> uint16 bfloat16 with round-to-nearest-even. NaNs
    are special-cased BEFORE the rounding add (the standard
    converter discipline): the +0x7FFF carry would wrap a negative
    NaN's uint32 pattern around zero and silently encode it as ~0.0,
    masking the divergence the NaN exists to surface."""
    xc = np.ascontiguousarray(x, dtype=np.float32)
    u = xc.view(np.uint32)
    rounded = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) &
                                       np.uint32(1))
    out = (rounded >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(xc)
    if nan.any():
        # keep sign/exponent, force a quiet-NaN mantissa bit
        out[nan] = ((u[nan] >> np.uint32(16)) |
                    np.uint32(0x0040)).astype(np.uint16)
    return out


def _bf16_expand(payload: np.ndarray,
                 shape: Tuple[int, ...]) -> np.ndarray:
    u = np.ascontiguousarray(payload, dtype=np.uint16).astype(np.uint32)
    return (u << np.uint32(16)).view(np.float32).reshape(shape)


class _TreeWalker:
    """Shared recursive walk over job/update data trees (dicts, lists,
    tuples) applying ``_visit`` to eligible arrays. Rebuilds only the
    containers on the path to a replaced leaf."""

    def _visit(self, path: Tuple, value: Any) -> Any:
        raise NotImplementedError

    def _leaf(self, path: Tuple, value: Any) -> Any:
        return value

    def _walk(self, value: Any, path: Tuple) -> Any:
        if isinstance(value, dict):
            return {key: self._walk(item, path + (key,))
                    for key, item in value.items()}
        if isinstance(value, (list, tuple)):
            walked = [self._walk(item, path + (i,))
                      for i, item in enumerate(value)]
            return type(value)(walked) if isinstance(value, tuple) \
                else walked
        if _eligible(value):
            return self._visit(path, value)
        return self._leaf(path, value)


class Encoder(_TreeWalker):
    """One direction's sender state: float32 mirrors of the receiver's
    decoded arrays (int8) / rounding residuals (bf16), keyed by the
    array's path in the data tree (unit id + piece key — stable across
    jobs). ``raw_bytes``/``coded_bytes`` account the coded arrays'
    logical float32 size vs their wire payload size."""

    def __init__(self, encoding: str = "none",
                 keyframe: str = "f32") -> None:
        if encoding not in SUPPORTED:
            raise ValueError("unknown encoding %r" % (encoding,))
        if keyframe not in ("f32", "quant"):
            raise ValueError("unknown keyframe policy %r" % (keyframe,))
        self.encoding = encoding
        self.keyframe = keyframe
        self._mirrors: Dict[Tuple, np.ndarray] = {}
        self._residuals: Dict[Tuple, np.ndarray] = {}
        #: per-path f32 scratch (hot path: one subtraction target per
        #: send instead of five fresh 2 MB allocations)
        self._scratch: Dict[Tuple, np.ndarray] = {}
        self.raw_bytes = 0
        self.coded_bytes = 0

    def encode(self, tree: Any) -> Any:
        if self.encoding == "none":
            return tree
        return self._walk(tree, ())

    # -- per-array ----------------------------------------------------------
    def _visit(self, path: Tuple, x: np.ndarray) -> CodedArray:
        self.raw_bytes += x.nbytes
        if self.encoding == "bf16":
            coded = self._encode_bf16(path, x)
        else:
            coded = self._encode_int8(path, x)
        self.coded_bytes += coded.payload.nbytes
        return coded

    def _encode_bf16(self, path: Tuple, x: np.ndarray) -> CodedArray:
        residual = self._residuals.get(path)
        if residual is not None and residual.shape == x.shape:
            target = x + residual
        else:
            target = np.array(x, dtype=np.float32)
        payload = _bf16_round(target)
        decoded = _bf16_expand(payload, target.shape)
        with np.errstate(invalid="ignore"):
            residual = target - decoded
        # a NaN/inf element has no meaningful rounding error — and a
        # NaN residual would pin that element to NaN in every FUTURE
        # frame through the feedback add, long after the value recovers
        residual[~np.isfinite(residual)] = 0.0
        self._residuals[path] = residual
        return CodedArray("bf16", x.shape, 0.0, payload)

    def _encode_int8(self, path: Tuple, x: np.ndarray) -> CodedArray:
        mirror = self._mirrors.get(path)
        if mirror is None or mirror.shape != x.shape:
            if self.keyframe == "f32":
                payload = np.array(x, dtype=np.float32)
                self._mirrors[path] = payload  # sender-private copy
                return CodedArray("f32key", x.shape, 0.0, payload)
            mirror = np.zeros(x.shape, dtype=np.float32)
            self._mirrors[path] = mirror
            kind = "int8key"
        else:
            kind = "int8"
        delta = self._scratch.get(path)
        if delta is None or delta.shape != x.shape:
            delta = np.empty(x.shape, dtype=np.float32)
            self._scratch[path] = delta
        np.subtract(x, mirror, out=delta)
        amax = float(max(delta.max(initial=0.0),
                         -delta.min(initial=0.0)))
        if not np.isfinite(amax) or amax == 0.0:
            # nothing to move (or a blown-up update the receiver can't
            # represent anyway): ship a zero delta, mirror unchanged
            payload = np.zeros(x.shape, dtype=np.int8)
            return CodedArray(kind, x.shape, 0.0, payload)
        scale = amax / 127.0
        # |delta/scale| <= 127 by construction, so rint needs no clip
        np.multiply(delta, np.float32(1.0 / scale), out=delta)
        np.rint(delta, out=delta)
        payload = delta.astype(np.int8)
        # advance the mirror by exactly what the receiver will decode
        np.multiply(delta, np.float32(scale), out=delta)
        mirror += delta
        return CodedArray(kind, x.shape, scale, payload)


class Decoder(_TreeWalker):
    """One direction's receiver state: float32 mirrors advanced by
    each received delta. The mirrors MUST advance on every received
    frame — a receiver that skips decoding (e.g. a post-completion
    discard) would apply the next delta against a stale reference —
    so decode unconditionally and discard the *result* if needed.
    ``raw_bytes``/``wire_bytes`` account the logical float32 size vs
    the wire payload size of eligible arrays; for ``none`` the decode
    is an identity walk that only counts (raw == wire)."""

    def __init__(self, encoding: str = "none") -> None:
        if encoding not in SUPPORTED:
            raise ValueError("unknown encoding %r" % (encoding,))
        self.encoding = encoding
        self._mirrors: Dict[Tuple, np.ndarray] = {}
        self.raw_bytes = 0
        self.wire_bytes = 0

    def decode(self, tree: Any) -> Any:
        if self.encoding == "none":
            self._count(tree)
            return tree
        return self._walk(tree, ())

    def _count(self, value: Any) -> None:
        if isinstance(value, dict):
            for item in value.values():
                self._count(item)
        elif isinstance(value, (list, tuple)):
            for item in value:
                self._count(item)
        elif _eligible(value):
            self.raw_bytes += value.nbytes
            self.wire_bytes += value.nbytes

    def _visit(self, path: Tuple, value: np.ndarray) -> np.ndarray:
        # an un-coded eligible array inside a coded stream (sender
        # below threshold rules differ only by constants) passes
        # through; count it raw
        self.raw_bytes += value.nbytes
        self.wire_bytes += value.nbytes
        return value

    def _leaf(self, path: Tuple, value: Any) -> Any:
        if not isinstance(value, CodedArray):
            return value
        shape = tuple(value.shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * 4
        self.raw_bytes += nbytes
        self.wire_bytes += value.payload.nbytes
        if value.kind == "bf16":
            return _bf16_expand(value.payload, shape)
        if value.kind == "f32key":
            arr = np.ascontiguousarray(
                value.payload, dtype=np.float32).reshape(shape)
            self._mirrors[path] = arr.copy()
            return arr
        if value.kind == "int8key":
            self._mirrors[path] = np.zeros(shape, dtype=np.float32)
        mirror = self._mirrors.get(path)
        if value.kind not in ("int8", "int8key") or mirror is None or \
                mirror.shape != shape:
            raise ConnectionError(
                "codec desync at %r: %s without a matching keyframe" %
                (path, value.kind))
        if value.scale:
            # one fused upcast-and-scale pass, then advance the mirror
            step = np.multiply(value.payload, np.float32(value.scale),
                               dtype=np.float32)
            mirror += step
        # the mirror is receiver-private state: hand out a copy so a
        # unit that mutates the applied params in place cannot corrupt
        # the delta chain
        return mirror.copy()
