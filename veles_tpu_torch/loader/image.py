"""Image dataset loaders: directory or file-list image datasets with
scaling, cropping, letterboxing onto a background and grey or RGB
colour.

Port of ``veles_tpu/loader/image.py``: PIL only decodes (imported when
an image is decoded, not with the module), the geometry runs in numpy
on the host, and the arrays are bitwise the reference's for the same
files. ``ImageLoader`` decodes each minibatch on the host (with a
random horizontal mirror on TRAIN from the loader's stream);
``FullBatchImageLoader`` decodes the whole set once into a resident
dataset whose minibatches are gathered on the device;
``FullBatchImageLoaderMSE`` pairs each input with a target image.
Every image comes out at one static shape.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from veles_tpu_torch.loader.base import LABEL_DTYPE, TRAIN
from veles_tpu_torch.loader.file_loader import FileListLoaderBase
from veles_tpu_torch.loader.fullbatch import (FullBatchLoader,
                                              FullBatchLoaderMSE)


def make_background(size: Tuple[int, int], channels: int,
                    background: Any = None) -> np.ndarray:
    """Resolve a background spec -> float32 HWC canvas in [0, 1].

    ``background``: None (black), an int/float tuple per channel
    (0-255 ints or 0-1 floats — the reference's ``background_color``,
    veles/loader/image.py:344-368), an ndarray of the canvas shape, or
    a path to an image file (``background_image``)."""
    th, tw = size
    if background is None:
        return np.zeros((th, tw, channels), dtype=np.float32)
    if isinstance(background, str):
        background = decode_image(
            background, "GRAY" if channels == 1 else "RGB", size)
    if isinstance(background, np.ndarray):
        if background.shape != (th, tw, channels):
            raise ValueError(
                "background shape %s != canvas shape %s" %
                (background.shape, (th, tw, channels)))
        return background.astype(np.float32)
    color = np.asarray(background, dtype=np.float32)
    if color.shape != (channels,):
        raise ValueError("background color needs %d channels, got %r" %
                         (channels, background))
    if color.max() > 1.0:  # 0-255 ints, reference-style
        color = color / 255.0
    return np.broadcast_to(color, (th, tw, channels)).astype(
        np.float32).copy()


def decode_image(path: str, color_space: str = "RGB",
                 size: Optional[Tuple[int, int]] = None,
                 crop: Optional[Tuple[int, int]] = None,
                 scale_mode: str = "fit",
                 background: Any = None) -> np.ndarray:
    """Decode one image file -> float32 HWC in [0, 1].

    size: (H, W) resize target; crop: (H, W) center crop applied after
    the resize; scale_mode:

    - "fit"       aspect-distorting resize to exactly ``size``;
    - "crop"      aspect-preserving resize (shorter side matches) then
                  center crop to ``size``;
    - "letterbox" aspect-preserving resize (longer side matches) pasted
                  centered onto a ``background`` canvas — the
                  reference's background blending
                  (veles/loader/image.py:444-476 scale_image pastes the
                  scaled image onto self.background).
    """
    from PIL import Image

    img = Image.open(path)
    img = img.convert("L" if color_space == "GRAY" else "RGB")
    letterboxed = None
    if size is not None:
        th, tw = size
        if scale_mode == "crop":
            w, h = img.size
            ratio = max(th / h, tw / w)
            img = img.resize((max(tw, int(round(w * ratio))),
                              max(th, int(round(h * ratio)))),
                             Image.BILINEAR)
            w, h = img.size
            left, top = (w - tw) // 2, (h - th) // 2
            img = img.crop((left, top, left + tw, top + th))
        elif scale_mode == "letterbox":
            w, h = img.size
            ratio = min(th / h, tw / w)
            dw = min(tw, max(1, int(round(w * ratio))))
            dh = min(th, max(1, int(round(h * ratio))))
            img = img.resize((dw, dh), Image.BILINEAR)
            letterboxed = ((th - dh) // 2, (tw - dw) // 2)
        else:
            img = img.resize((tw, th), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if letterboxed is not None:
        top, left = letterboxed
        canvas = make_background(size, arr.shape[2], background)
        canvas[top:top + arr.shape[0], left:left + arr.shape[1]] = arr
        arr = canvas
    if crop is not None:
        ch, cw = crop
        h, w = arr.shape[:2]
        top, left = (h - ch) // 2, (w - cw) // 2
        arr = arr[top:top + ch, left:left + cw]
    return arr


class ImageLoader(FileListLoaderBase):
    """Streaming image loader: decodes images per minibatch on the
    host (for datasets too large to keep resident; the resident path is
    FullBatchImageLoader).

    kwargs: ``size`` (H, W) target; ``color_space`` RGB|GRAY;
    ``scale_mode`` fit|crop; ``mirror`` False|True (random horizontal
    flip on TRAIN, from the keyed stream).
    """

    MAPPING = "image"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.size: Tuple[int, int] = tuple(kwargs.pop("size", (32, 32)))
        self.color_space: str = kwargs.pop("color_space", "RGB")
        self.scale_mode: str = kwargs.pop("scale_mode", "fit")
        self.mirror: bool = kwargs.pop("mirror", False)
        # reference: background_image wins over background_color
        # (veles/loader/image.py:316-341); explicit None-check — the
        # image may be an ndarray, whose truth value raises
        bg_img = kwargs.pop("background_image", None)
        bg_color = kwargs.pop("background_color", None)
        self.background: Any = bg_img if bg_img is not None else bg_color
        kwargs.setdefault("file_pattern", "*")
        super().__init__(workflow, **kwargs)
        self.has_labels = True

    @property
    def channels(self) -> int:
        return 1 if self.color_space == "GRAY" else 3

    def load_data(self) -> None:
        super().load_data()
        # imagenet-style directory labels
        self.labels_mapping = {}

    def create_minibatch_data(self) -> None:
        shape = (self.max_minibatch_size,) + self.size + (self.channels,)
        self.minibatch_data.reset(np.zeros(shape, dtype=np.float32))
        self.minibatch_labels.reset(
            np.zeros(self.max_minibatch_size, dtype=LABEL_DTYPE))

    def fill_minibatch(self) -> None:
        indices = self.minibatch_indices.map_read()
        data = self.minibatch_data.map_invalidate()
        for i in range(self.minibatch_size):
            path, _ = self.sample_table[int(indices[i])]
            img = decode_image(path, self.color_space, self.size,
                               scale_mode=self.scale_mode,
                               background=self.background)
            if self.mirror and self.minibatch_class == TRAIN and \
                    self.rand.random_sample() < 0.5:
                img = img[:, ::-1]
            data[i] = img
            self.raw_minibatch_labels[i] = self.label_of_file(path)


class FullBatchImageLoader(FullBatchLoader, FileListLoaderBase):
    """Decodes the whole image dataset once into a resident array;
    per-step gather then runs on device (reference:
    veles/loader/fullbatch_image.py). Path scanning, kwargs, and
    directory-name labels are inherited from FileListLoaderBase;
    residency + device gather from FullBatchLoader."""

    MAPPING = "full_batch_image"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.size: Tuple[int, int] = tuple(kwargs.pop("size", (32, 32)))
        self.color_space: str = kwargs.pop("color_space", "RGB")
        self.scale_mode: str = kwargs.pop("scale_mode", "fit")
        bg_img = kwargs.pop("background_image", None)
        bg_color = kwargs.pop("background_color", None)
        self.background: Any = bg_img if bg_img is not None else bg_color
        super().__init__(workflow, **kwargs)
        self.has_labels = True

    @property
    def channels(self) -> int:
        return 1 if self.color_space == "GRAY" else 3

    def load_data(self) -> None:
        FileListLoaderBase.load_data(self)  # scan -> sample_table
        if not self.sample_table:
            raise FileNotFoundError("no image files found")
        shape = (len(self.sample_table),) + self.size + (self.channels,)
        self.original_data = np.zeros(shape, dtype=np.float32)
        labels = []
        for i, (path, _) in enumerate(self.sample_table):
            self.original_data[i] = decode_image(
                path, self.color_space, self.size,
                scale_mode=self.scale_mode, background=self.background)
            labels.append(self.label_of_file(path))
        keys = sorted(set(labels))
        self.labels_mapping = {k: j for j, k in enumerate(keys)}
        self.original_labels = np.array(
            [self.labels_mapping[lbl] for lbl in labels],
            dtype=LABEL_DTYPE)


class FullBatchImageLoaderMSE(FullBatchLoaderMSE, FullBatchImageLoader):
    """Image dataset with IMAGE targets for reconstruction/regression
    training (reference: veles/loader/image_mse.py — ImageLoaderMSE
    pairs each input with a target image; FileImageLoaderMSEMixin
    matches targets by label). Target residency + device gather come
    from FullBatchLoaderMSE; decoding/letterboxing from
    FullBatchImageLoader (cooperative MRO).

    ``target_paths``: directories holding the target images. Matching:
    by file stem when every input stem has a target stem, else by the
    directory-derived label (the reference's target_label_map). With
    no ``target_paths`` the inputs themselves are the targets
    (autoencoder/denoising reconstruction).
    """

    MAPPING = "full_batch_image_mse"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.target_paths = kwargs.pop("target_paths", None)
        super().__init__(workflow, **kwargs)

    def _decode_target(self, path: str) -> np.ndarray:
        return decode_image(path, self.color_space, self.size,
                            scale_mode=self.scale_mode,
                            background=self.background)

    def load_data(self) -> None:
        super().load_data()
        if self.target_paths is None:
            self.original_targets = self.original_data.copy()
            return
        import glob
        import os
        target_files = sorted(
            f for d in self.target_paths
            for f in glob.glob(os.path.join(d, "**", "*"), recursive=True)
            if os.path.isfile(f))
        if not target_files:
            raise FileNotFoundError("no target images under %r" %
                                    (self.target_paths,))
        stem = lambda p: os.path.splitext(os.path.basename(p))[0]  # noqa: E731
        by_stem = {stem(p): p for p in target_files}
        input_stems = [stem(p) for p, _ in self.sample_table]
        if all(s in by_stem for s in input_stems):
            matched = [by_stem[s] for s in input_stems]
        else:
            # one target per label class (reference target_label_map)
            by_label = {self.label_of_file(p): p for p in target_files}
            missing = [lbl for lbl in self.labels_mapping
                       if lbl not in by_label]
            if missing:
                raise ValueError(
                    "no target image for labels %s (targets match "
                    "neither stems nor labels)" % missing)
            matched = [by_label[self.label_of_file(p)]
                       for p, _ in self.sample_table]
        shape = (len(matched),) + self.size + (self.channels,)
        self.original_targets = np.zeros(shape, dtype=np.float32)
        for i, path in enumerate(matched):
            self.original_targets[i] = self._decode_target(path)
