"""Built-in datasets: deterministic synthetic digit and color images.

Port of ``veles_tpu/loader/datasets.py``. The sample workflows train on
a deterministic synthetic digit dataset (5x7-font glyphs upscaled to
28x28, randomly shifted, intensity-jittered and noised) and its
CIFAR-shaped color variant, drawn on the host from a stream seeded only
by ``root.common.random.seed`` (``_dataset_stream``): the port's
streams draw the reference's exact host values, so the data and labels
are bitwise the reference's. If a real MNIST ``.npz`` (keys
x_train/y_train/x_test/y_test) is found under
``root.common.dirs.datasets``, ``SyntheticDigitsLoader`` serves it
instead.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader

# Classic 5x7 digit font, one string per digit, rows space-separated.
_FONT = [
    "01110 10001 10011 10101 11001 10001 01110",
    "00100 01100 00100 00100 00100 00100 01110",
    "01110 10001 00001 00010 00100 01000 11111",
    "11111 00010 00100 00010 00001 10001 01110",
    "00010 00110 01010 10010 11111 00010 00010",
    "11111 10000 11110 00001 00001 10001 01110",
    "00110 01000 10000 11110 10001 10001 01110",
    "11111 00001 00010 00100 01000 01000 01000",
    "01110 10001 10001 01110 10001 10001 01110",
    "01110 10001 10001 01111 00001 00010 01100",
]


def _glyphs(size: int = 28, scale: int = 3) -> np.ndarray:
    """[10, size, size] float32 glyph canvases (5x7 font, upscaled)."""
    out = np.zeros((10, size, size), dtype=np.float32)
    for digit, rows in enumerate(_FONT):
        bitmap = np.array([[int(c) for c in row]
                           for row in rows.split()], dtype=np.float32)
        big = np.kron(bitmap, np.ones((scale, scale), dtype=np.float32))
        h, w = big.shape
        y0 = (size - h) // 2
        x0 = (size - w) // 2
        out[digit, y0:y0 + h, x0:x0 + w] = big
    return out


def synthetic_digits(n_samples: int, rand, size: int = 28,
                     max_shift: int = 4, noise: float = 0.15):
    """Deterministic digit images: (data [N, size, size] f32 in [0, 1],
    labels [N] int). Vectorized host-side generation."""
    glyphs = _glyphs(size)
    labels = rand.randint(0, 10, n_samples).astype(np.int64)
    data = glyphs[labels].copy()
    # Random integer shifts via per-sample roll (vectorized with take).
    dy = rand.randint(-max_shift, max_shift + 1, n_samples)
    dx = rand.randint(-max_shift, max_shift + 1, n_samples)
    row_idx = (np.arange(size)[None, :] - dy[:, None]) % size
    col_idx = (np.arange(size)[None, :] - dx[:, None]) % size
    data = data[np.arange(n_samples)[:, None, None],
                row_idx[:, :, None], col_idx[:, None, :]]
    intensity = 0.6 + 0.4 * rand.random_sample(n_samples)
    data *= intensity[:, None, None].astype(np.float32)
    data += rand.random_sample(data.shape).astype(np.float32) * noise
    np.clip(data, 0.0, 1.0, out=data)
    return data.astype(np.float32), labels


def synthetic_color_images(n_samples: int, rand, size: int = 32,
                           noise: float = 0.2):
    """CIFAR-shaped deterministic dataset: [N, size, size, 3] in [0,1].
    Each class = a glyph shape with a class-linked (but jittered) color
    on a noisy background, randomly shifted — learnable by conv nets,
    nontrivial for linear ones."""
    gray, labels = synthetic_digits(n_samples, rand, size,
                                    max_shift=size // 7, noise=0.0)
    # class-linked base colors, jittered per-sample
    base = np.array([[(c * 37 % 83) / 83.0, (c * 53 % 71) / 71.0,
                      (c * 71 % 59) / 59.0] for c in range(10)],
                    dtype=np.float32) * 0.7 + 0.3
    color = base[labels] + rand.random_sample(
        (n_samples, 3)).astype(np.float32) * 0.2 - 0.1
    data = gray[..., None] * color[:, None, None, :]
    data += rand.random_sample(data.shape).astype(np.float32) * noise
    np.clip(data, 0.0, 1.0, out=data)
    return data.astype(np.float32), labels


class SyntheticColorImagesLoader(FullBatchLoader):
    """CIFAR-shaped synthetic dataset loader (32x32x3, 10 classes)."""

    MAPPING = "synthetic_color"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.n_train = kwargs.pop("n_train", 5000)
        self.n_valid = kwargs.pop("n_valid", 1000)
        self.n_test = kwargs.pop("n_test", 0)
        self.image_size = kwargs.pop("image_size", 32)
        self.noise = kwargs.pop("noise", 0.2)
        super().__init__(workflow, **kwargs)

    def load_data(self) -> None:
        self.has_labels = True
        n = self.n_test + self.n_valid + self.n_train
        data, labels = synthetic_color_images(
            n, _dataset_stream("synthetic_color"), self.image_size,
            noise=self.noise)
        self.original_data = data
        self.original_labels = labels
        self.class_lengths = [self.n_test, self.n_valid, self.n_train]


def _dataset_stream(name: str):
    """A fresh stream seeded only by the global seed — every process
    (coordinator, every worker) must materialize the SAME dataset no
    matter what its other streams have consumed."""
    from veles_tpu_torch import prng as prng_mod
    return prng_mod.RandomGenerator(
        name, seed=int(root.common.random.seed))


class SyntheticDigitsLoader(FullBatchLoader):
    """FullBatch loader over the synthetic digit dataset (MNIST-shaped:
    28x28 grayscale, 10 classes)."""

    MAPPING = "synthetic_digits"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.n_train = kwargs.pop("n_train", 6000)
        self.n_valid = kwargs.pop("n_valid", 1000)
        self.n_test = kwargs.pop("n_test", 0)
        self.image_size = kwargs.pop("image_size", 28)
        self.noise = kwargs.pop("noise", 0.15)
        super().__init__(workflow, **kwargs)

    def _find_real_mnist(self) -> Optional[str]:
        base = str(root.common.dirs.datasets or "")
        for name in ("mnist.npz",):
            path = os.path.join(base, name) if base else name
            if base and os.path.isfile(path):
                return path
        return None

    def load_data(self) -> None:
        self.has_labels = True
        real = self._find_real_mnist()
        if real is not None:
            with np.load(real) as z:
                x_train, y_train = z["x_train"], z["y_train"]
                x_test, y_test = z["x_test"], z["y_test"]
            self.info("using real MNIST at %s", real)
            data = np.concatenate([x_test, x_train]).astype(np.float32)
            if data.max() > 1.5:
                data /= 255.0
            self.original_data = data
            self.original_labels = np.concatenate(
                [y_test, y_train]).astype(np.int64)
            self.class_lengths = [0, len(x_test), len(x_train)]
            return
        n = self.n_test + self.n_valid + self.n_train
        data, labels = synthetic_digits(
            n, _dataset_stream("synthetic_digits"), self.image_size,
            noise=self.noise)
        # Serving order is TEST, VALID, TRAIN (cumulative offsets).
        self.original_data = data
        self.original_labels = labels
        self.class_lengths = [self.n_test, self.n_valid, self.n_train]
