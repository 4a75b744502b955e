"""Update-codec tests of the port's farm
(``veles_tpu_torch.distributed.compress``): the JAX package's
``tests/test_compress.py`` cases (bf16 / int8-delta encodings with
error-feedback accumulation, the probe-skip wire path, negotiation),
and payloads and scales bitwise equal to the JAX package's codec on the
same arrays."""

import pickle

import numpy as np
import pytest

from veles_tpu_torch.distributed import compress
import veles_tpu.distributed.compress as R_compress
from veles_tpu_torch.distributed.compress import (CodedArray, Decoder,
                                                  Encoder, negotiate)


def _wire(tree):
    """Round-trip through pickle like the real frame path does."""
    return pickle.loads(pickle.dumps(tree, protocol=5))


def _rng(seed=0):
    return np.random.default_rng(seed)


# -- int8 successive-state delta -------------------------------------------
def test_int8_quant_keyframe_then_deltas_track_sender():
    """The decoder's reconstruction tracks the sender's true state:
    the keyframe lands within max|x|/254 per element, every delta
    frame within max|delta|/254 — error feedback folds each frame's
    rounding error into the next delta, so the error never
    accumulates."""
    enc = Encoder("int8", keyframe="quant")
    dec = Decoder("int8")
    x = _rng(0).standard_normal(4096).astype(np.float32)
    out = dec.decode(_wire(enc.encode({"w": x.copy()})))["w"]
    assert np.abs(out - x).max() <= np.abs(x).max() / 254 + 1e-6
    for step in range(1, 6):
        x = x + np.float32(0.01) * _rng(step).standard_normal(
            4096).astype(np.float32)
        out = dec.decode(_wire(enc.encode({"w": x.copy()})))["w"]
        # bound: half an int8 LSB of the per-frame delta range; the
        # delta includes the previous frame's feedback, bounded by
        # one LSB itself
        assert np.abs(out - x).max() <= 2 * 0.01 * 4 / 254 + 1e-5, step


def test_int8_f32_keyframe_is_exact():
    """Coordinator->worker policy: the first (bootstrap) frame of each
    array ships as raw float32 — a joiner's params are bit-exact."""
    enc = Encoder("int8", keyframe="f32")
    dec = Decoder("int8")
    x = _rng(1).standard_normal(2048).astype(np.float32)
    coded = enc.encode({"params": x.copy()})
    assert coded["params"].kind == "f32key"
    out = dec.decode(_wire(coded))["params"]
    np.testing.assert_array_equal(out, x)
    # second frame is a delta at 1 byte/element
    coded2 = enc.encode({"params": x + np.float32(0.001)})
    assert coded2["params"].kind == "int8"
    assert coded2["params"].payload.dtype == np.int8


def test_int8_exactly_4x_fewer_payload_bytes():
    """With quantized keyframes the whole update stream is 1 byte per
    element: raw/coded accounting is exactly 4x (scales ride the
    pickle stream, not the payload)."""
    enc = Encoder("int8", keyframe="quant")
    for seed in range(4):
        enc.encode({"w": _rng(seed).standard_normal(
            100000).astype(np.float32)})
    assert enc.raw_bytes == 4 * enc.coded_bytes
    dec = Decoder("int8")
    dec.decode(_wire(Encoder("int8", keyframe="quant").encode(
        {"w": _rng(9).standard_normal(100000).astype(np.float32)})))
    assert dec.raw_bytes == 4 * dec.wire_bytes


def test_int8_shape_change_rekeyframes():
    enc = Encoder("int8", keyframe="quant")
    dec = Decoder("int8")
    a = _rng(2).standard_normal(1024).astype(np.float32)
    dec.decode(_wire(enc.encode({"w": a})))
    b = _rng(3).standard_normal(2048).astype(np.float32)
    coded = enc.encode({"w": b.copy()})
    assert coded["w"].kind == "int8key"  # fresh keyframe, not a delta
    out = dec.decode(_wire(coded))["w"]
    assert out.shape == b.shape
    assert np.abs(out - b).max() <= np.abs(b).max() / 254 + 1e-6


def test_int8_delta_without_keyframe_is_clean_error():
    dec = Decoder("int8")
    orphan = {"w": CodedArray("int8", (256,), 0.5,
                              np.zeros(256, np.int8))}
    with pytest.raises(ConnectionError, match="keyframe"):
        dec.decode(orphan)


def test_decoded_arrays_are_private_and_writable():
    """Mutating an applied array must not corrupt the decoder's
    mirror (the next delta applies against receiver state)."""
    enc = Encoder("int8", keyframe="quant")
    dec = Decoder("int8")
    x = _rng(4).standard_normal(1024).astype(np.float32)
    out = dec.decode(_wire(enc.encode({"w": x.copy()})))["w"]
    out[:] = 999.0  # unit mutates its copy in place
    x2 = x + np.float32(0.01)
    out2 = dec.decode(_wire(enc.encode({"w": x2.copy()})))["w"]
    assert np.abs(out2 - x2).max() < 1e-3  # mirror unharmed


# -- bf16 -------------------------------------------------------------------
def test_bf16_roundtrip_and_residual_feedback():
    enc = Encoder("bf16")
    dec = Decoder("bf16")
    x = _rng(5).standard_normal(4096).astype(np.float32)
    out = dec.decode(_wire(enc.encode({"w": x.copy()})))["w"]
    # bf16 has 8 mantissa bits: relative error < 2^-8
    assert np.abs(out - x).max() <= np.abs(x).max() * 2 ** -8
    # error feedback: resending the SAME x dithers the rounding so the
    # time-average converges well below one bf16 ULP
    outs = [dec.decode(_wire(enc.encode({"w": x.copy()})))["w"]
            for _ in range(16)]
    mean = np.mean(outs, axis=0)
    assert np.abs(mean - x).max() < np.abs(x).max() * 2 ** -10
    assert enc.raw_bytes == 2 * enc.coded_bytes


def test_bf16_nan_survives_encoding():
    """NaNs must stay NaN through bf16 (the naive +0x7FFF rounding add
    wraps a NEGATIVE NaN's uint32 pattern to ~0.0, silently masking a
    divergence); infinities pass through too."""
    enc = Encoder("bf16")
    dec = Decoder("bf16")
    x = _rng(11).standard_normal(512).astype(np.float32)
    x[3] = np.float32(np.nan)
    x[7] = -np.float32(np.nan)              # negative quiet NaN
    # negative SIGNALING NaN: the exact pattern the rounding add wraps
    x[11] = np.array([0xFF800001], dtype=np.uint32).view(np.float32)[0]
    x[15] = np.float32(np.inf)
    out = dec.decode(_wire(enc.encode({"w": x.copy()})))["w"]
    assert np.isnan(out[3]) and np.isnan(out[7]) and np.isnan(out[11])
    assert np.isinf(out[15]) and out[15] > 0
    assert np.isfinite(out[[0, 1, 2]]).all()
    # the NaN must NOT be pinned by the residual: once the value
    # recovers, the next frame decodes finite again
    x[3] = x[7] = x[11] = x[15] = np.float32(1.0)
    out2 = dec.decode(_wire(enc.encode({"w": x.copy()})))["w"]
    assert np.isfinite(out2).all()


# -- none / tree mechanics --------------------------------------------------
def test_none_encoding_is_identity_and_counts():
    enc = Encoder("none")
    dec = Decoder("none")
    tree = {"u": {"params": _rng(6).standard_normal(
        1024).astype(np.float32), "idx": 3}}
    assert enc.encode(tree) is tree           # same object, no walk
    assert dec.decode(tree) is tree           # identity + accounting
    assert dec.raw_bytes == dec.wire_bytes == 4096


def test_small_and_non_float_arrays_pass_through():
    enc = Encoder("int8", keyframe="quant")
    small = np.ones(16, np.float32)           # < MIN_CODE_ELEMS
    ints = np.arange(5000, dtype=np.int32)    # not float32
    f64 = np.ones(5000, np.float64)
    tree = enc.encode({"s": small, "i": ints, "d": f64,
                       "nested": [small, {"x": ints}]})
    assert tree["s"] is small
    assert tree["i"] is ints
    assert tree["d"] is f64
    assert tree["nested"][0] is small
    assert tree["nested"][1]["x"] is ints


def test_nested_containers_and_stable_paths():
    enc = Encoder("int8", keyframe="quant")
    dec = Decoder("int8")
    a = _rng(7).standard_normal(512).astype(np.float32)
    b = _rng(8).standard_normal(512).astype(np.float32)
    tree = {"gd1": {"weights": a.copy(), "bias": b.copy()},
            "stack": (a.copy(), [b.copy()])}
    out = dec.decode(_wire(enc.encode(tree)))
    assert isinstance(out["stack"], tuple)
    for got, want in ((out["gd1"]["weights"], a),
                      (out["gd1"]["bias"], b),
                      (out["stack"][0], a), (out["stack"][1][0], b)):
        assert np.abs(got - want).max() <= \
            np.abs(want).max() / 254 + 1e-6


def test_zero_delta_ships_zero_scale():
    enc = Encoder("int8", keyframe="quant")
    dec = Decoder("int8")
    x = _rng(9).standard_normal(1024).astype(np.float32)
    first = dec.decode(_wire(enc.encode({"w": x.copy()})))["w"]
    again = enc.encode({"w": first.copy()})  # resend decoded state
    assert again["w"].scale == 0.0
    out = dec.decode(_wire(again))["w"]
    np.testing.assert_array_equal(out, first)


# -- negotiation ------------------------------------------------------------
def test_negotiate():
    assert negotiate("int8", ["int8", "bf16", "none"]) == "int8"
    assert negotiate("bf16", ["int8", "bf16"]) == "bf16"
    assert negotiate("int8", []) == "none"       # old worker, no list
    assert negotiate("int8", None) == "none"
    assert negotiate("none", ["int8"]) == "none"
    assert negotiate(None, ["int8"]) == "none"
    assert negotiate("int8", ["bf16"]) == "none"  # no overlap


def test_unknown_encoding_rejected():
    with pytest.raises(ValueError):
        Encoder("zstd")
    with pytest.raises(ValueError):
        Decoder("zstd")
    with pytest.raises(ValueError):
        Encoder("int8", keyframe="nope")
    assert "int8" in compress.SUPPORTED
    assert "bf16" in compress.SUPPORTED


# -- bitwise against the JAX package's codec --------------------------------
@pytest.mark.parametrize("encoding,keyframe", [("int8", "f32"),
                                               ("int8", "quant"),
                                               ("bf16", "f32")])
def test_payloads_and_scales_are_the_references(encoding, keyframe):
    """Five successive states of a parameter tree through both
    packages' encoders: every coded payload and scale is bitwise the
    JAX package's, and the two decoders reconstruct the same arrays
    bitwise. (A coded frame names its package's ``CodedArray`` class,
    so coded streams do not cross packages; plain frames do, see
    ``test_torch_protocol.py``.)"""
    rng = _rng(9)
    state = {"fc": {"w": rng.standard_normal((96, 80)).astype(np.float32),
                    "b": rng.standard_normal(4096).astype(np.float32)},
             "idx": np.arange(10)}
    port, ref = Encoder(encoding, keyframe), R_compress.Encoder(
        encoding, keyframe)
    port_dec, ref_dec = Decoder(encoding), R_compress.Decoder(encoding)
    for step in range(5):
        got, want = port.encode(state), ref.encode(state)
        for key in ("w", "b"):
            g, w = got["fc"][key], want["fc"][key]
            assert (g.kind, tuple(g.shape)) == (w.kind, tuple(w.shape))
            assert np.float32(g.scale).tobytes() == \
                np.float32(w.scale).tobytes()
            assert g.payload.dtype == w.payload.dtype
            assert g.payload.tobytes() == w.payload.tobytes()
        mine, theirs = port_dec.decode(_wire(got)), ref_dec.decode(
            _wire(want))
        for key in ("w", "b"):
            assert mine["fc"][key].tobytes() == \
                theirs["fc"][key].tobytes()
        state = {"fc": {k: v + 0.01 * rng.standard_normal(
            v.shape).astype(np.float32) for k, v in state["fc"].items()},
            "idx": state["idx"]}
    assert port.coded_bytes == ref.coded_bytes
    assert port.raw_bytes == ref.raw_bytes
