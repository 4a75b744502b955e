"""Data normalization registry.

Port of ``veles_tpu/normalization.py``: a ``NormalizerRegistry`` from
names to normalizer classes; a stateful normalizer runs ``analyze``
over the training set (host numpy, as the reference), then applies to
every minibatch; a ``StatelessNormalizer`` skips the analysis. The
``state`` property saves and restores a normalizer.

The application step, :meth:`NormalizerBase.apply_torch`, is a plain
function on tensors (the reference's ``apply_jax``): the full-batch
loader runs it on the device inside its minibatch gather, with the
learned statistics put on the device once and passed in through
``arrays`` (:meth:`NormalizerBase.stat_arrays`). The statistics are
cast to the data's floating dtype, so f32 data is normalized in f32 as
the reference's JAX arithmetic does. :meth:`NormalizerBase.normalize`
is the host form: the same function on a CPU tensor over the numpy
minibatch, in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


class NormalizerRegistry(type):
    """MAPPING name -> normalizer class."""

    normalizers: Dict[str, type] = {}

    def __init__(cls, name, bases, namespace):
        super().__init__(name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if mapping:
            NormalizerRegistry.normalizers[mapping] = cls


def normalizer(name: str, **kwargs: Any) -> "NormalizerBase":
    ncls = NormalizerRegistry.normalizers.get(name)
    if ncls is None:
        raise ValueError("Unknown normalization type %r (known: %s)" %
                         (name, sorted(NormalizerRegistry.normalizers)))
    return ncls(**kwargs)


def _float_dtype(data: torch.Tensor) -> torch.dtype:
    return data.dtype if data.is_floating_point() else torch.float32


class NormalizerBase(metaclass=NormalizerRegistry):
    """Base: analyze (accumulate statistics) then apply.

    ``apply_torch`` takes an optional ``arrays`` mapping (the fields
    named by ``ARRAY_FIELDS``, as :meth:`stat_arrays` gives them, host
    arrays or tensors already on the data's device); without it the
    statistics are read from ``self`` and copied to the data's device
    on every call."""

    MAPPING: Optional[str] = None

    #: names of the learned-statistic attributes ``apply_torch`` reads
    ARRAY_FIELDS: tuple = ()

    def __init__(self, **kwargs: Any) -> None:
        self._initialized = False

    def stat_arrays(self) -> Dict[str, np.ndarray]:
        """The learned statistics as host arrays, keyed by field."""
        out: Dict[str, np.ndarray] = {}
        for field in self.ARRAY_FIELDS:
            value = getattr(self, field, None)
            if value is not None:
                out[field] = np.asarray(value)
        return out

    def _stats(self, data: torch.Tensor, arrays) -> Dict[str, torch.Tensor]:
        a = arrays if arrays is not None else self.stat_arrays()
        return {k: torch.as_tensor(v, device=data.device).to(
                    _float_dtype(data)) for k, v in a.items()}

    @property
    def is_initialized(self) -> bool:
        return self._initialized

    # -- statistics pass ---------------------------------------------------
    def analyze(self, data: np.ndarray) -> None:
        self._analyze(np.asarray(data))
        self._initialized = True

    def _analyze(self, data: np.ndarray) -> None:
        pass

    def reset(self) -> None:
        self._initialized = False

    # -- application -------------------------------------------------------
    def normalize(self, data: np.ndarray) -> None:
        """In-place host normalization of a numpy minibatch."""
        data[...] = self.apply_torch(torch.as_tensor(data)).numpy()

    def apply_torch(self, data: torch.Tensor, arrays=None) -> torch.Tensor:
        """The normalization as a plain function on a tensor."""
        return data

    # -- picklable state (the reference's normalizer.state) ----------------
    @property
    def state(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}

    @state.setter
    def state(self, value: Dict[str, Any]) -> None:
        self.__dict__.update(value)


class StatelessNormalizer(NormalizerBase):
    """No analysis needed."""

    def analyze(self, data: np.ndarray) -> None:
        self._initialized = True


class NoneNormalizer(StatelessNormalizer):
    """Identity."""

    MAPPING = "none"


class LinearNormalizer(NormalizerBase):
    """Scale each feature linearly into ``interval`` using the min/max
    observed over the training set ('linear')."""

    MAPPING = "linear"

    ARRAY_FIELDS = ("dmin", "dmax")

    def __init__(self, interval=(-1.0, 1.0), **kwargs):
        super().__init__(**kwargs)
        self.interval = tuple(interval)
        self.dmin: Optional[np.ndarray] = None
        self.dmax: Optional[np.ndarray] = None

    def _analyze(self, data: np.ndarray) -> None:
        flat = data.reshape(len(data), -1)
        dmin = flat.min(axis=0)
        dmax = flat.max(axis=0)
        if self.dmin is None:
            self.dmin, self.dmax = dmin, dmax
        else:
            self.dmin = np.minimum(self.dmin, dmin)
            self.dmax = np.maximum(self.dmax, dmax)

    def apply_torch(self, data, arrays=None):
        s = self._stats(data, arrays)
        lo, hi = self.interval
        dmin = s["dmin"]
        span = s["dmax"] - dmin
        span = torch.where(span == 0, torch.ones_like(span), span)
        flat = data.reshape(data.shape[0], -1)
        out = (flat - dmin) / span * (hi - lo) + lo
        return out.reshape(data.shape)


class RangeLinearNormalizer(StatelessNormalizer):
    """Fixed source range -> target interval ('range_linear')."""

    MAPPING = "range_linear"

    def __init__(self, source=(0.0, 255.0), interval=(-1.0, 1.0), **kwargs):
        super().__init__(**kwargs)
        self.source = tuple(source)
        self.interval = tuple(interval)

    def apply_torch(self, data, arrays=None):
        slo, shi = self.source
        lo, hi = self.interval
        return (data - slo) / (shi - slo) * (hi - lo) + lo


class MeanDispNormalizer(NormalizerBase):
    """(x - mean) / dispersion with statistics from the training set
    ('mean_disp')."""

    MAPPING = "mean_disp"

    ARRAY_FIELDS = ("mean", "disp")

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._sum: Optional[np.ndarray] = None
        self._sum_sq: Optional[np.ndarray] = None
        self._count = 0
        self.mean: Optional[np.ndarray] = None
        self.disp: Optional[np.ndarray] = None

    def _analyze(self, data: np.ndarray) -> None:
        flat = data.reshape(len(data), -1).astype(np.float64)
        if self._sum is None:
            self._sum = flat.sum(axis=0)
            self._sum_sq = (flat ** 2).sum(axis=0)
        else:
            self._sum += flat.sum(axis=0)
            self._sum_sq += (flat ** 2).sum(axis=0)
        self._count += len(flat)
        self.mean = (self._sum / self._count).astype(np.float32)
        var = self._sum_sq / self._count - self.mean.astype(np.float64) ** 2
        self.disp = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)

    def apply_torch(self, data, arrays=None):
        s = self._stats(data, arrays)
        flat = data.reshape(data.shape[0], -1)
        return ((flat - s["mean"]) / s["disp"]).reshape(data.shape)


class ExternalMeanNormalizer(StatelessNormalizer):
    """Subtract a provided mean array ('external_mean')."""

    MAPPING = "external_mean"

    ARRAY_FIELDS = ("mean",)

    def __init__(self, mean_source=None, **kwargs):
        super().__init__(**kwargs)
        if mean_source is None:
            raise ValueError("external_mean requires mean_source")
        self.mean = np.asarray(mean_source, dtype=np.float32)

    def apply_torch(self, data, arrays=None):
        s = self._stats(data, arrays)
        flat = data.reshape(data.shape[0], -1)
        return (flat - s["mean"].reshape(-1)).reshape(data.shape)


class InternalMeanNormalizer(NormalizerBase):
    """Subtract the training-set mean ('internal_mean')."""

    MAPPING = "internal_mean"

    ARRAY_FIELDS = ("mean",)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._sum = None
        self._count = 0
        self.mean = None

    def _analyze(self, data: np.ndarray) -> None:
        flat = data.reshape(len(data), -1).astype(np.float64)
        self._sum = flat.sum(axis=0) if self._sum is None \
            else self._sum + flat.sum(axis=0)
        self._count += len(flat)
        self.mean = (self._sum / self._count).astype(np.float32)

    def apply_torch(self, data, arrays=None):
        s = self._stats(data, arrays)
        flat = data.reshape(data.shape[0], -1)
        return (flat - s["mean"]).reshape(data.shape)


class PointwiseNormalizer(NormalizerBase):
    """Per-point linear map trained so each input cell spans [-1, 1]
    ('pointwise')."""

    MAPPING = "pointwise"

    ARRAY_FIELDS = ("dmin", "dmax")

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.dmin = None
        self.dmax = None

    def _analyze(self, data: np.ndarray) -> None:
        dmin = data.min(axis=0)
        dmax = data.max(axis=0)
        self.dmin = dmin if self.dmin is None else np.minimum(
            self.dmin, dmin)
        self.dmax = dmax if self.dmax is None else np.maximum(
            self.dmax, dmax)

    def apply_torch(self, data, arrays=None):
        s = self._stats(data, arrays)
        dmin = s["dmin"]
        span = s["dmax"] - dmin
        span = torch.where(span == 0, torch.ones_like(span), span)
        return (data - dmin) / span * 2.0 - 1.0


class ExpNormalizer(StatelessNormalizer):
    """tanh-like squash: 2/(1+exp(-x)) - 1 ('exp')."""

    MAPPING = "exp"

    def apply_torch(self, data, arrays=None):
        return 2.0 / (1.0 + torch.exp(-data)) - 1.0
