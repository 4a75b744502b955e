"""Restricted Boltzmann Machine units (Bernoulli-Bernoulli, CD-1).

Port of ``veles_tpu/nn/rbm.py``. One trainer step runs the whole CD-1
chain (hidden probabilities, hidden sample, reconstruction, the second
hidden pass and the three parameter updates, written in place), with
the reference's ``valid`` mask for a partial minibatch and products
through :func:`veles_tpu_torch.nn.all2all.dot` (operands in the compute
dtype, sums and results in the weights' dtype). The hidden sample is
``fill < h0p``, where ``fill`` is one uniform fill of the trainer's
``prng`` stream (K8 on the card, the same Philox in plain PyTorch on
the CPU, bitwise equal). The reference draws ``jax.random.bernoulli``,
which compares ``jax.random.uniform`` with the same probabilities:
:func:`_rbm_cd1` takes the fill as an argument, so the two packages
sample the same bits when they are given the same fill.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.all2all import dot
from veles_tpu_torch.nn.filling import fill_weights


def _rbm_hidden(v, w, hb, compute_dtype):
    v2 = v.reshape(v.shape[0], -1)
    return torch.sigmoid(dot(v2, w, compute_dtype, w.dtype) + hb)


def _rbm_cd1(w, vb, hb, v0, fill, size: int, lr: float, compute_dtype):
    """One CD-1 update of ``w``, ``vb`` and ``hb`` in place, the hidden
    sample ``fill < h0p``; returns the summed squared reconstruction
    error as a device scalar."""
    batch = v0.shape[0]
    v0 = v0.reshape(batch, -1)
    valid = (torch.arange(batch, device=w.device) < size).to(
        w.dtype)[:, None]
    v0 = v0 * valid

    h0p = torch.sigmoid(dot(v0, w, compute_dtype, w.dtype) + hb)
    h0s = (fill < h0p).to(w.dtype)
    v1p = torch.sigmoid(dot(h0s, w.T, compute_dtype, w.dtype) + vb) * valid
    h1p = torch.sigmoid(dot(v1p, w, compute_dtype, w.dtype) + hb)

    n = float(max(size, 1))
    dw = (dot(v0.T, h0p, compute_dtype, w.dtype) -
          dot(v1p.T, h1p, compute_dtype, w.dtype)) / n
    dvb = (v0 - v1p).sum(dim=0) / n
    dhb = (h0p - h1p).sum(dim=0) / n
    err = ((v0 - v1p) ** 2).sum()
    w.add_(lr * dw)
    vb.add_(lr * dvb)
    hb.add_(lr * dhb)
    return err


class RBM(AcceleratedUnit):
    """Forward: the hidden units' probabilities given the visible
    minibatch. kwargs: ``n_hidden``."""

    MAPPING = "rbm"
    MAPPING_GROUP = "unsupervised"
    #: inference is exactly sigmoid(x @ W + hbias), the all2all unit's
    #: operation, so the export takes its UUID
    EXPORT_UUID = "veles.tpu.all2all"

    def export_spec(self):
        """(props, arrays) of the layer, as an all2all sigmoid layer."""
        return ({"activation": "sigmoid", "include_bias": True},
                {"weights": self.weights.map_read(),
                 "bias": self.hbias.map_read()})

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.n_hidden: int = kwargs.pop("n_hidden")
        self.weights_stddev = kwargs.pop("weights_stddev", 0.01)
        prng_stream = kwargs.pop("prng_stream", "default")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.output = Array()
        self.weights = Array()      # [visible, hidden]
        self.vbias = Array()
        self.hbias = Array()
        self.rand = prng.get(prng_stream)
        self.demand("input")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True
        batch = self.input.shape[0]
        n_visible = int(np.prod(self.input.shape[1:]))
        dtype = self.device.precision_dtype
        if not self.weights or self.weights.shape != (n_visible,
                                                      self.n_hidden):
            self.init_array("weights", data=fill_weights(
                self.rand, (n_visible, self.n_hidden), "gaussian",
                self.weights_stddev).astype(dtype))
            self.init_array("vbias", data=np.zeros(n_visible, dtype))
            self.init_array("hbias",
                            data=np.zeros(self.n_hidden, dtype))
        else:
            for attr in ("weights", "vbias", "hbias"):
                self.init_array(attr)
        self.init_array("output", shape=(batch, self.n_hidden),
                        dtype=dtype)
        self._fwd_ = self.jit(_rbm_hidden, static_argnums=(3,))
        return None

    def run(self) -> None:
        self.output.devmem = self._fwd_(
            self.input.devmem, self.weights.devmem, self.hbias.devmem,
            self.device.compute_dtype)


class RBMTrainer(AcceleratedUnit):
    """CD-1 trainer twin: shares ``weights``/``vbias``/``hbias`` with
    the forward RBM (``link_attrs``) and demands the visible minibatch
    and its size. ``recon_err`` is one host read a step."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.learning_rate: float = kwargs.pop("learning_rate", 0.1)
        prng_stream = kwargs.pop("prng_stream", "rbm_sample")
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.batch_size: Optional[int] = None
        self.weights: Optional[Array] = None
        self.vbias: Optional[Array] = None
        self.hbias: Optional[Array] = None
        self.recon_err = 0.0
        self.rand = prng.get(prng_stream)
        self.demand("input", "batch_size", "weights", "vbias", "hbias")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.weights:
            return True
        self._step_ = self.jit(_rbm_cd1, static_argnums=(7,),
                               donate_argnums=(0, 1, 2))
        return None

    def run(self) -> None:
        params = (self.weights, self.vbias, self.hbias)
        w, vb, hb = (arr.devmem for arr in params)
        fill = self.rand.uniform((self.input.shape[0], w.shape[1]),
                                 dtype=torch.float32, device=w.device)
        err = self._step_(w, vb, hb, self.input.devmem, fill,
                          int(self.batch_size), float(self.learning_rate),
                          self.device.compute_dtype)
        for arr, t in zip(params, (w, vb, hb)):
            arr.devmem = t
        self.recon_err = float(err)
