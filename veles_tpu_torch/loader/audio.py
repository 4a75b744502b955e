"""Audio file loader: fixed-length windows of decoded audio files.

Port of ``veles_tpu/loader/audio.py``: WAV decodes through
``scipy.io.wavfile``; other formats (flac, ogg) through the optional
``soundfile`` module, with an error naming it when it is absent. Each
file yields ``window_size``-sample windows every ``window_step``
samples, so every example has one static shape; labels are the
containing directory's name.
"""

from __future__ import annotations

import os
from typing import Any, Tuple

import numpy as np

from veles_tpu_torch.loader.base import LABEL_DTYPE
from veles_tpu_torch.loader.file_loader import FileListLoaderBase


def decode_audio(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 samples [n, channels], sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        from scipy.io import wavfile
        rate, data = wavfile.read(path)
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        elif data.dtype.kind == "u":
            info = np.iinfo(data.dtype)
            data = (data.astype(np.float32) - info.max / 2) / (info.max / 2)
        else:
            data = data.astype(np.float32)
    else:
        try:
            import soundfile
        except ImportError as e:
            raise RuntimeError(
                "decoding %s requires the optional soundfile module; "
                "only .wav is supported without it" % path) from e
        data, rate = soundfile.read(path, dtype="float32")
    if data.ndim == 1:
        data = data[:, None]
    return data, rate


class AudioFileLoader(FileListLoaderBase):
    """kwargs: ``window_size`` (samples per training example),
    ``window_step`` (default = window_size, i.e. no overlap). Labels
    come from the containing directory name."""

    MAPPING = "audio"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.window_size: int = kwargs.pop("window_size", 16000)
        self.window_step: int = kwargs.pop("window_step", None) or \
            self.window_size
        kwargs.setdefault("file_pattern", "*.wav")
        super().__init__(workflow, **kwargs)
        self.has_labels = True
        self._window_cache_: dict = {}

    def samples_in_file(self, path: str) -> int:
        data, _ = self._decode_cached(path)
        n = (len(data) - self.window_size) // self.window_step + 1
        return max(n, 0)

    def _decode_cached(self, path: str) -> Tuple[np.ndarray, int]:
        if path not in self._window_cache_:
            if len(self._window_cache_) > 64:
                self._window_cache_.clear()
            self._window_cache_[path] = decode_audio(path)
        return self._window_cache_[path]

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._window_cache_ = {}

    def create_minibatch_data(self) -> None:
        # channel count from the first file
        first = self.sample_table[0][0]
        channels = self._decode_cached(first)[0].shape[1]
        shape = (self.max_minibatch_size, self.window_size, channels)
        self.minibatch_data.reset(np.zeros(shape, dtype=np.float32))
        self.minibatch_labels.reset(
            np.zeros(self.max_minibatch_size, dtype=LABEL_DTYPE))

    def fill_minibatch(self) -> None:
        indices = self.minibatch_indices.map_read()
        data = self.minibatch_data.map_invalidate()
        for i in range(self.minibatch_size):
            path, win = self.sample_table[int(indices[i])]
            samples, _ = self._decode_cached(path)
            start = win * self.window_step
            data[i] = samples[start:start + self.window_size]
            self.raw_minibatch_labels[i] = self.label_of_file(path)
