"""Port parity of the loader family on the CPU: file scanning, the
image, HDF5, pickle, audio and text loaders, minibatch record and
replay, the interactive and stream loaders, ``InputJoiner``,
``Avatar``, ``Downloader`` and ``MeanDispNormalizer`` of
``veles_tpu_torch`` against the JAX package's, on the same files.

Tolerances. Every loader's arrays are compared bitwise with the
reference's: decoding, scaling and the served minibatches are the same
numpy and PIL calls on the same files (f32 in [0, 1]). ``InputJoiner``
is a copy and ``MeanDispNormalizer`` one f32 subtraction and product
on each side: both bitwise. Saver files are read across packages both
ways. PIL and h5py come through ``pytest.importorskip``.
"""

import os
import pickle
import tarfile
import threading
import zipfile

import numpy as np
import pytest
import torch

import veles_tpu.avatar as R_avatar
import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.downloader as R_downloader
import veles_tpu.input_joiner as R_joiner
import veles_tpu.loader as R_loader
import veles_tpu.loader.base as R_base
import veles_tpu.loader.hdfs as R_hdfs
import veles_tpu.loader.image as R_image
import veles_tpu.loader.text as R_text
import veles_tpu.mean_disp_normalizer as R_mdn
import veles_tpu.memory as R_memory
import veles_tpu.prng as R_prng
import veles_tpu.workflow as R_workflow
import veles_tpu_torch.avatar as P_avatar
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.downloader as P_downloader
import veles_tpu_torch.input_joiner as P_joiner
import veles_tpu_torch.loader as P_loader
import veles_tpu_torch.loader.base as P_base
import veles_tpu_torch.loader.hdfs as P_hdfs
import veles_tpu_torch.loader.image as P_image
import veles_tpu_torch.loader.text as P_text
import veles_tpu_torch.mean_disp_normalizer as P_mdn
import veles_tpu_torch.memory as P_memory
import veles_tpu_torch.prng as P_prng
import veles_tpu_torch.workflow as P_workflow

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

REF = dict(avatar=R_avatar, backends=R_backends, downloader=R_downloader,
           joiner=R_joiner, loader=R_loader, base=R_base, hdfs=R_hdfs,
           image=R_image, text=R_text, mdn=R_mdn, memory=R_memory,
           workflow=R_workflow)
PORT = dict(avatar=P_avatar, backends=P_backends, downloader=P_downloader,
            joiner=P_joiner, loader=P_loader, base=P_base, hdfs=P_hdfs,
            image=P_image, text=P_text, mdn=P_mdn, memory=P_memory,
            workflow=P_workflow)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh_streams():
    saved = [c.root.common.random.seed for c in (R_config, P_config)]
    for c, p in ((R_config, R_prng), (P_config, P_prng)):
        c.root.common.random.seed = 42
        p.reset()
    yield
    for c, p, seed in zip((R_config, P_config), (R_prng, P_prng), saved):
        c.root.common.random.seed = seed
        p.reset()


def _device(mods):
    return mods["backends"].Device(backend="cpu")


def _wf(mods):
    wf = mods["workflow"].Workflow()
    wf.thread_pool = None
    return wf


def _host(arr):
    """An Array's host copy (the reference's may be a jax.Array)."""
    return np.asarray(arr.map_read())


def _both(make):
    """``make(mods)`` on the reference and the port."""
    return [make(mods) for mods in SIDES]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _write_images(base, klass_dir, labels_counts, size=(8, 8)):
    from PIL import Image
    d = base / klass_dir
    for label, count in labels_counts.items():
        (d / label).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            arr = (np.random.RandomState(sum(map(ord, label)) + i)
                   .rand(*size, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / label / ("img%d.png" % i))
    return str(d)


# -- file scanning ---------------------------------------------------------

def test_scan_files_sorted_and_filtered(tmp_path):
    (tmp_path / "a" / "sub").mkdir(parents=True)
    for name in ("2.png", "1.png", "x.txt", "sub/0.png"):
        (tmp_path / "a" / name).write_bytes(b"z")
    for recursive in (True, False):
        found = _both(lambda m: m["loader"].scan_files(
            [str(tmp_path / "a")], "*.png", recursive))
        assert found[0] == found[1]
    assert [os.path.basename(p) for p in P_loader.scan_files(
        [str(tmp_path / "a")], "*.png", False)] == ["1.png", "2.png"]
    with pytest.raises(FileNotFoundError):
        P_loader.scan_files([str(tmp_path / "missing")])


# -- image loaders ---------------------------------------------------------

def test_image_loader_streaming(tmp_path):
    pytest.importorskip("PIL")
    train = _write_images(tmp_path, "train", {"cat": 3, "dog": 3})
    valid = _write_images(tmp_path, "valid", {"cat": 1, "dog": 1})
    served = []
    for mods in SIDES:
        loader = mods["loader"].ImageLoader(
            _wf(mods), train_paths=[train], validation_paths=[valid],
            size=(8, 8), minibatch_size=4, mirror=True)
        assert loader.initialize(device=_device(mods)) is None
        assert loader.class_lengths == [0, 2, 6]
        batches = []
        for _ in range(3):  # VALID, then TRAIN (mirrored at random)
            loader.run()
            batches.append((loader.minibatch_class, loader.minibatch_size,
                            _host(loader.minibatch_data).copy(),
                            _host(loader.minibatch_labels).copy()))
        served.append(batches)
    for (rc, rs, rd, rl), (pc, ps, pd, pl) in zip(*served):
        assert (rc, rs) == (pc, ps)
        _same(pd, rd)
        _same(pl, rl)
        assert set(pl[:ps].tolist()) <= {0, 1}
    assert served[1][0][2].shape == (4, 8, 8, 3)


def test_full_batch_image_loader(tmp_path):
    pytest.importorskip("PIL")
    train = _write_images(tmp_path, "train", {"a": 2, "b": 2})
    loaders = []
    for mods in SIDES:
        loader = mods["loader"].FullBatchImageLoader(
            _wf(mods), train_paths=[train], size=(8, 8), minibatch_size=2)
        assert loader.initialize(device=_device(mods)) is None
        loader.run()
        loaders.append(loader)
    ref, port = loaders
    assert port.original_data.shape == (4, 8, 8, 3)
    _same(port.original_data, ref.original_data)
    _same(port.original_labels, ref.original_labels)
    assert sorted(port.labels_mapping) == ["a", "b"]
    assert port.labels_mapping == ref.labels_mapping
    _same(_host(port.minibatch_data), _host(ref.minibatch_data))
    _same(_host(port.minibatch_labels), _host(ref.minibatch_labels))


def test_decode_image_modes(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    arr = (np.random.RandomState(0).rand(20, 10, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "img.png")
    Image.fromarray(arr).save(p)
    for kw, shape in ((dict(size=(8, 8)), (8, 8, 3)),
                      (dict(size=(8, 8), scale_mode="crop"), (8, 8, 3)),
                      (dict(color_space="GRAY", size=(6, 4)), (6, 4, 1)),
                      (dict(size=(10, 10), crop=(6, 4)), (6, 4, 3)),
                      (dict(), (20, 10, 3))):
        ref, port = _both(lambda m: m["image"].decode_image(p, **kw))
        assert port.shape == shape
        _same(port, ref)


def test_decode_image_letterbox_background(tmp_path):
    """A tall 20 x 10 image letterboxed into a 12 x 12 canvas lands
    centred (12 x 6 of content) with the background in the margins;
    the arrays are bitwise the reference's."""
    Image = pytest.importorskip("PIL.Image")
    arr = np.full((20, 10, 3), 255, dtype=np.uint8)  # all white
    p = str(tmp_path / "img.png")
    Image.fromarray(arr).save(p)
    canvas = np.zeros((12, 12, 3), np.float32)
    canvas[..., 2] = 0.5
    for background in ((255, 20, 147), canvas, (0.25, 0.5, 1.0), None):
        ref, port = _both(lambda m: m["image"].decode_image(
            p, size=(12, 12), scale_mode="letterbox",
            background=background))
        _same(port, ref)
        np.testing.assert_allclose(port[:, 3:9], 1.0)
    out = P_image.decode_image(p, size=(12, 12), scale_mode="letterbox",
                               background=(255, 20, 147))
    np.testing.assert_allclose(out[:, :3, 0], 1.0)
    np.testing.assert_allclose(out[:, :3, 1], 20 / 255.0, atol=1e-6)
    np.testing.assert_allclose(out[:, 9:, 2], 147 / 255.0, atol=1e-6)
    for bg in ((1, 2), np.zeros((3, 3, 3), np.float32)):
        with pytest.raises(ValueError):
            P_image.make_background((12, 12), 3, bg)


def test_full_batch_image_mse_loader(tmp_path):
    """Reconstruction loader: targets matched by stem, gathered beside
    the data on the device; with no ``target_paths`` the inputs are the
    targets."""
    Image = pytest.importorskip("PIL.Image")
    train = _write_images(tmp_path, "train", {"a": 2, "b": 2})
    tdir = tmp_path / "targets"
    tdir.mkdir()
    rng = np.random.RandomState(5)
    for i in range(2):
        arr = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tdir / ("img%d.png" % i))
    loaders = []
    for mods in SIDES:
        loader = mods["image"].FullBatchImageLoaderMSE(
            _wf(mods), train_paths=[train], target_paths=[str(tdir)],
            size=(8, 8), minibatch_size=2)
        assert loader.initialize(device=_device(mods)) is None
        loader.run()
        loaders.append(loader)
    ref, port = loaders
    assert port.original_targets.shape == (4, 8, 8, 3)
    _same(port.original_targets, ref.original_targets)
    _same(_host(port.minibatch_targets), _host(ref.minibatch_targets))
    auto = P_image.FullBatchImageLoaderMSE(
        _wf(PORT), train_paths=[train], size=(8, 8), minibatch_size=2)
    assert auto.initialize(device=_device(PORT)) is None
    _same(auto.original_targets, auto.original_data)


# -- hdf5 / pickles --------------------------------------------------------

def test_hdf5_loader(tmp_path):
    h5py = pytest.importorskip("h5py")
    train, valid = str(tmp_path / "tr.h5"), str(tmp_path / "va.h5")
    rng = np.random.RandomState(1)
    for path, n in ((valid, 4), (train, 10)):
        with h5py.File(path, "w") as f:
            f["data"] = rng.rand(n, 5).astype(np.float32)
            f["labels"] = rng.randint(0, 3, n)
    loaders = []
    for mods in SIDES:
        loader = mods["loader"].HDF5Loader(
            _wf(mods), train_file=train, validation_file=valid,
            minibatch_size=4)
        assert loader.initialize(device=_device(mods)) is None
        loader.run()
        loaders.append(loader)
    ref, port = loaders
    assert port.class_lengths == ref.class_lengths == [0, 4, 10]
    assert port.has_labels and port.minibatch_class == P_base.VALID
    _same(port.original_data, ref.original_data)
    _same(port.original_labels, ref.original_labels)
    _same(_host(port.minibatch_data), _host(ref.minibatch_data))


def test_pickles_loader(tmp_path):
    rng = np.random.RandomState(2)
    train = str(tmp_path / "train.pickle")
    valid = str(tmp_path / "valid.pickle")
    with open(train, "wb") as f:
        pickle.dump((rng.rand(6, 4), rng.randint(0, 2, 6)), f)
    with open(valid, "wb") as f:
        pickle.dump({"data": rng.rand(3, 4), "labels": [0, 1, 1]}, f)
    loaders = []
    for mods in SIDES:
        loader = mods["loader"].PicklesLoader(
            _wf(mods), train_path=train, validation_path=valid,
            minibatch_size=3)
        assert loader.initialize(device=_device(mods)) is None
        loader.run()
        loader.run()
        loaders.append(loader)
    ref, port = loaders
    assert port.class_lengths == ref.class_lengths == [0, 3, 6]
    assert port.minibatch_size == 3
    _same(port.original_data, ref.original_data)
    _same(port.original_labels, ref.original_labels)
    _same(_host(port.minibatch_data), _host(ref.minibatch_data))
    _same(_host(port.minibatch_labels), _host(ref.minibatch_labels))


# -- audio -----------------------------------------------------------------

def test_audio_loader_wav(tmp_path):
    from scipy.io import wavfile
    d = tmp_path / "train" / "tone"
    d.mkdir(parents=True)
    rate = 8000
    t = np.arange(rate, dtype=np.float32) / rate
    wav = (np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    wavfile.write(str(d / "tone.wav"), rate, wav)
    wavfile.write(str(d / "u8.wav"), rate,
                  (wav // 256 + 128).astype(np.uint8))
    for name in ("tone.wav", "u8.wav"):
        (rd, rr), (pd, pr) = _both(
            lambda m: m["loader"].decode_audio(str(d / name)))
        assert rr == pr == rate
        _same(pd, rd)
    loaders = []
    for mods in SIDES:
        loader = mods["loader"].AudioFileLoader(
            _wf(mods), train_paths=[str(tmp_path / "train")],
            window_size=1000, window_step=700, minibatch_size=2)
        assert loader.initialize(device=_device(mods)) is None
        loader.run()
        loaders.append(loader)
    ref, port = loaders
    assert port.class_lengths[P_base.TRAIN] == 2 * 11  # (8000-1000)/700+1
    assert port.minibatch_data.shape == (2, 1000, 1)
    _same(_host(port.minibatch_data), _host(ref.minibatch_data))
    assert float(np.abs(_host(port.minibatch_data)).max()) <= 1.0
    (d / "x.flac").write_bytes(b"")
    try:
        import soundfile  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="soundfile"):
            P_loader.decode_audio(str(d / "x.flac"))


# -- text ------------------------------------------------------------------

def test_synthetic_text_windows_bitwise():
    """The token windows and the minibatches served from them are the
    reference's, bitwise, for one corpus seed."""
    loaders = []
    for mods in SIDES:
        loader = mods["text"].SyntheticTextLoader(
            _wf(mods), seq_len=15, n_tokens=2000, vocab=50,
            minibatch_size=8, corpus_seed=3)
        assert loader.initialize(device=_device(mods)) is None
        for _ in range(3):
            loader.run()
        loaders.append(loader)
    ref, port = loaders
    assert port.original_data.dtype == np.int32
    assert port.original_data.shape == (125, 16)
    assert port.class_lengths == ref.class_lengths == [0, 12, 113]
    _same(port.original_data, ref.original_data)
    _same(_host(port.minibatch_data), _host(ref.minibatch_data))
    with pytest.raises(ValueError, match="windows"):
        P_text.SyntheticTextLoader(
            _wf(PORT), seq_len=15, n_tokens=20).initialize(
                device=_device(PORT))


# -- record / replay -------------------------------------------------------

def _tiny_loader(mods):
    class TinyLoader(mods["base"].Loader):
        """4 train + 2 valid rows of 3 features, labels = row parity."""

        def load_data(self):
            self.class_lengths = [0, 2, 4]
            self.has_labels = True
            self._rows = np.arange(18, dtype=np.float32).reshape(6, 3)

        def create_minibatch_data(self):
            self.minibatch_data.reset(
                np.zeros((self.max_minibatch_size, 3), dtype=np.float32))
            self.minibatch_labels.reset(
                np.zeros(self.max_minibatch_size, dtype=np.int32))

        def fill_minibatch(self):
            idx = self.minibatch_indices.map_read()[:self.minibatch_size]
            self.minibatch_data.map_invalidate()[:self.minibatch_size] = \
                self._rows[np.asarray(idx)]
            for i, j in enumerate(idx):
                self.raw_minibatch_labels[i] = int(j) % 2

    return TinyLoader


def _save(mods, path):
    wf = _wf(mods)
    loader = _tiny_loader(mods)(wf, minibatch_size=2, shuffle_limit=0)
    assert loader.initialize(device=_device(mods)) is None
    saver = mods["loader"].MinibatchesSaver(wf, file=path)
    saver.minibatch_data = loader.minibatch_data
    saver.minibatch_labels = loader.minibatch_labels
    saver.minibatch_class = loader.minibatch_class
    saver.minibatch_size = loader.minibatch_size
    assert saver.initialize() is None
    for _ in range(3):  # one epoch: 1 valid + 2 train minibatches
        loader.run()
        saver.minibatch_class = loader.minibatch_class
        saver.minibatch_size = loader.minibatch_size
        saver.run()
    saver.stop()


def test_minibatches_save_then_replay_across_packages(tmp_path):
    """Each package's saver file replays in both packages' loaders, and
    the records are the same."""
    paths = {}
    for tag, mods in (("ref", REF), ("port", PORT)):
        paths[tag] = str(tmp_path / ("%s.dat.gz" % tag))
        _save(mods, paths[tag])
    records = [list(m["loader"].read_minibatches(paths[t]))
               for t, m in (("ref", REF), ("port", PORT))]
    assert len(records[0]) == len(records[1]) == 3
    for (rk, rs, rd, rl), (pk, ps, pd, pl) in zip(*records):
        assert (rk, rs) == (pk, ps)
        _same(pd, rd)
        _same(pl, rl)
    for path in paths.values():
        for mods in SIDES:
            replay = mods["loader"].MinibatchesLoader(
                _wf(mods), file=path, minibatch_size=2, shuffle_limit=0)
            assert replay.initialize(device=_device(mods)) is None
            assert replay.class_lengths == [0, 2, 4]
            replay.run()
            np.testing.assert_array_equal(
                _host(replay.minibatch_data),
                [[0, 1, 2], [3, 4, 5]])  # valid rows first, unshuffled
            np.testing.assert_array_equal(
                _host(replay.minibatch_labels), [0, 1])


# -- interactive / stream --------------------------------------------------

def test_interactive_loader():
    for mods in SIDES:
        loader = mods["loader"].InteractiveLoader(
            _wf(mods), sample_shape=(3,), minibatch_size=2)
        assert loader.initialize(device=_device(mods)) is None
        loader.feed(np.arange(9).reshape(3, 3))
        loader.close()
        loader.run()
        assert loader.minibatch_size == 2
        assert loader.minibatch_class == P_base.TEST
        np.testing.assert_array_equal(_host(loader.minibatch_data),
                                      [[0, 1, 2], [3, 4, 5]])
        loader.run()
        assert loader.minibatch_size == 1
        np.testing.assert_array_equal(_host(loader.minibatch_data),
                                      [[6, 7, 8], [0, 0, 0]])
        assert bool(loader.last_minibatch)
        with pytest.raises(ValueError, match="shape"):
            loader.feed(np.ones(4))


def test_queue_loader_serves_again_after_stop():
    """stop() arms the shared ManagedThreads stop event; a
    re-initialized loader resets it and serves normally again."""
    loader = P_loader.InteractiveLoader(_wf(PORT), sample_shape=(3,),
                                        minibatch_size=2)
    assert loader.initialize(device=_device(PORT)) is None
    loader.stop()
    loader.stopped = False  # what a re-run of the workflow does
    assert loader.initialize(device=_device(PORT)) is None
    loader.feed(np.ones((2, 3)))
    loader.close()
    loader.run()
    assert loader.minibatch_size == 2


def _stream_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("StreamLoader/")]


def test_stream_loader_over_tcp():
    """Frames from two connections, then a close from a third: every
    row sent before the close is served before it, in two full
    minibatches, whatever the order the receiving threads run in. Port
    0, timeouts on every wait, and no thread left after ``stop()``."""
    loader = P_loader.StreamLoader(_wf(PORT), sample_shape=(4,),
                                   minibatch_size=2, feed_timeout=60)
    assert loader.initialize(device=_device(PORT)) is None
    endpoint = loader.endpoint
    assert endpoint[1] != 0
    failures = []

    def feeder():
        try:
            P_loader.send_stream(endpoint, np.full((2, 4), 7.0))
            P_loader.send_stream(endpoint, np.full((1, 4), 8.0))
            P_loader.send_stream(endpoint, np.full(4, 9.0))
            P_loader.send_stream(endpoint, None)
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(e)

    t = threading.Thread(target=feeder, name="feeder")
    t.start()
    try:
        loader.run()
        first = _host(loader.minibatch_data).copy()
        assert loader.minibatch_size == 2
        loader.run()
        second = _host(loader.minibatch_data).copy()
        assert loader.minibatch_size == 2
        loader.run()
        assert loader.minibatch_size == 0 and bool(loader.last_minibatch)
        assert _stream_threads()  # the accept loop until stop()
    finally:
        t.join(timeout=30)
        loader.stop()
    assert not t.is_alive() and not failures
    np.testing.assert_array_equal(first, np.full((2, 4), 7.0))
    np.testing.assert_array_equal(second, [[8.0] * 4, [9.0] * 4])
    assert _stream_threads() == []


def test_stream_loader_close_waits_for_earlier_connections():
    """16 senders at once (more threads than cores, a short switch
    interval) each send part of a frame and hold their connection; a
    close is sent on a 17th and given time to arrive; then the senders
    finish. All 16 rows are served before the stream ends: the close
    waits for the connections accepted before it."""
    import pickle
    import socket
    import struct
    import sys
    import time

    loader = P_loader.StreamLoader(_wf(PORT), sample_shape=(2,),
                                   minibatch_size=4, feed_timeout=60)
    assert loader.initialize(device=_device(PORT)) is None
    endpoint = loader.endpoint
    started = threading.Semaphore(0)
    go = threading.Event()

    def sender(i):
        payload = pickle.dumps(np.full(2, float(i), np.float32),
                               protocol=4)
        frame = struct.pack("!I", len(payload)) + payload
        with socket.create_connection(endpoint, timeout=30) as conn:
            conn.sendall(frame[:6])
            started.release()
            go.wait(30)
            conn.sendall(frame[6:])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    served = []
    senders = [threading.Thread(target=sender, args=(i,), name="sender")
               for i in range(16)]
    try:
        for t in senders:
            t.start()
        assert all(started.acquire(timeout=30) for _ in senders)
        P_loader.send_stream(endpoint, None)
        time.sleep(0.3)  # the close frame is read meanwhile
        go.set()
        while not bool(loader.last_minibatch):
            loader.run()
            served.extend(_host(loader.minibatch_data)[
                :loader.minibatch_size, 0].tolist())
    finally:
        go.set()
        for t in senders:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
        loader.stop()
    assert not any(t.is_alive() for t in senders)
    assert sorted(served) == [float(i) for i in range(16)]
    assert _stream_threads() == []


# -- InputJoiner / Avatar / MeanDispNormalizer / Downloader ----------------

def _joined(mods):
    device = _device(mods)
    joiner = mods["joiner"].InputJoiner(_wf(mods), num_inputs=3)
    arrays = [np.ones((2, 3), dtype=np.float32),
              np.arange(8, dtype=np.float32).reshape(2, 2, 2),
              np.arange(2, dtype=np.int32).reshape(2, 1)]
    for i, data in enumerate(arrays):
        arr = mods["memory"].Array(data=data)
        arr.initialize(device)
        setattr(joiner, "input_%d" % i, arr)
    assert joiner.initialize(device=device) is None
    joiner.run()
    return _host(joiner.output)


def test_input_joiner():
    ref, port = _both(_joined)
    assert port.shape == (2, 8) and port.dtype == np.float32
    np.testing.assert_array_equal(port[1], [1, 1, 1, 4, 5, 6, 7, 1])
    _same(port, ref)
    joiner = P_joiner.InputJoiner(_wf(PORT), num_inputs=2)
    joiner.input_0 = P_memory.Array(data=np.ones((2, 3), np.float32))
    joiner.input_1 = P_memory.Array(data=np.ones((3, 3), np.float32))
    with pytest.raises(ValueError, match="batch sizes"):
        joiner.initialize(device=_device(PORT))


def test_avatar_reflects_loader():
    for mods in SIDES:
        wf = _wf(mods)
        loader = _tiny_loader(mods)(wf, minibatch_size=2, shuffle_limit=0)
        avatar = mods["avatar"].Avatar(wf, source=loader)
        assert avatar.initialize() is True  # the source is not ready
        assert loader.initialize(device=_device(mods)) is None
        assert avatar.initialize() is None
        for _ in range(2):
            loader.run()
            avatar.run()
            np.testing.assert_array_equal(_host(avatar.minibatch_data),
                                          _host(loader.minibatch_data))
            np.testing.assert_array_equal(_host(avatar.minibatch_labels),
                                          _host(loader.minibatch_labels))
            assert avatar.minibatch_class == loader.minibatch_class
            assert avatar.minibatch_offset == loader.minibatch_offset
    # a device-served source is shared, not copied
    data = P_memory.Array(data=np.ones((2, 3), np.float32))
    data.initialize(_device(PORT))
    source = type("Src", (), {})()
    source.minibatch_data = data
    mirror = P_avatar.Avatar(_wf(PORT), source=source)
    mirror.run()
    assert mirror.minibatch_data.devmem is data.devmem


def _normalized(mods):
    device = _device(mods)
    dataset = np.random.RandomState(3).rand(10, 4).astype(np.float32) * 9
    dataset[:, 2] = 5.0  # zero dispersion: rdisp 1
    unit = mods["mdn"].MeanDispNormalizer.from_dataset(_wf(mods), dataset)
    x = mods["memory"].Array(data=dataset[:5])
    x.initialize(device)
    unit.input = x
    assert unit.initialize(device=device) is None
    unit.run()
    return dataset, unit


def test_mean_disp_normalizer():
    (dataset, ref), (_, port) = _both(_normalized)
    out = _host(port.output)
    assert out.dtype == np.float32
    _same(out, _host(ref.output))
    expected = (dataset[:5] - dataset.mean(0)) * np.where(
        np.ptp(dataset, 0) > 0, 1 / np.where(np.ptp(dataset, 0) > 0,
                                             np.ptp(dataset, 0), 1), 1)
    np.testing.assert_allclose(out, expected, rtol=1e-6, atol=1e-6)
    props, arrays = port.export_spec()
    assert props == {} and sorted(arrays) == ["mean", "rdisp"]
    _same(arrays["rdisp"], ref.export_spec()[1]["rdisp"])
    bad = P_mdn.MeanDispNormalizer.from_dataset(_wf(PORT), dataset[:, :3])
    bad.input = P_memory.Array(data=dataset[:5])
    with pytest.raises(ValueError, match="mean shape"):
        bad.initialize(device=_device(PORT))


def test_downloader_local_archive(tmp_path):
    """A zip by path, a tgz by ``file://`` URL and a plain file: each
    package extracts or copies the same tree; a stamp file makes the
    second initialize a no-op."""
    src = tmp_path / "src"
    src.mkdir()
    with zipfile.ZipFile(src / "payload.zip", "w") as zf:
        zf.writestr("inner/data.txt", "hello")
    (src / "t.txt").write_text("tar member")
    with tarfile.open(src / "payload.tgz", "w:gz") as tf:
        tf.add(str(src / "t.txt"), arcname="tarred/t.txt")
    (src / "plain.bin").write_bytes(b"\x00\x01")
    for tag, mods in (("ref", REF), ("port", PORT)):
        dest = tmp_path / ("datasets_%s" % tag)
        for url in (str(src / "payload.zip"),
                    "file://%s" % (src / "payload.tgz"),
                    str(src / "plain.bin")):
            dl = mods["downloader"].Downloader(_wf(mods), url=url,
                                               directory=str(dest))
            assert dl.initialize() is None
            assert dl.initialize() is None  # stamped: skipped
        assert (dest / "inner" / "data.txt").read_text() == "hello"
        assert (dest / "tarred" / "t.txt").read_text() == "tar member"
        assert (dest / "plain.bin").read_bytes() == b"\x00\x01"
    trees = [sorted(os.path.relpath(os.path.join(d, f), str(root))
                    for d, _, fs in os.walk(str(root)) for f in fs)
             for root in (tmp_path / "datasets_ref",
                          tmp_path / "datasets_port")]
    assert trees[0] == trees[1]


def test_hdfs_text_loader_chunks():
    """HDFSTextLoader streams line chunks, padded with "" on the last
    short one, and raises ``finished`` at the end; the transport is
    pluggable, so no Hadoop cluster is needed here."""
    lines = ["line %d" % i for i in range(7)]
    seen = {}
    for tag, mods in (("ref", REF), ("port", PORT)):
        loader = mods["hdfs"].HDFSTextLoader(
            _wf(mods), file="/data/x.txt", chunk=3,
            reader=lambda: iter(lines))
        assert loader.initialize() is None
        chunks = []
        while not loader.finished:
            loader.run()
            chunks.append((loader.chunk_size, list(loader.output)))
        seen[tag] = chunks
    assert seen["port"] == seen["ref"]
    assert seen["port"][-1] == (1, ["line 6", "", ""])
    assert [x for n, out in seen["port"] for x in out[:n]] == lines
    # the real transports: the same choice as the reference, or its
    # error when none is present
    import shutil
    have = shutil.which("hdfs") is not None
    for name in ("pyarrow", "hdfs"):
        try:
            __import__(name)
            have = True
        except ImportError:
            pass
    if have:
        assert type(P_hdfs.open_hdfs_lines("/x")).__name__ == "generator"
    else:
        with pytest.raises(RuntimeError, match="No HDFS transport"):
            P_hdfs.open_hdfs_lines("/data/x.txt")
