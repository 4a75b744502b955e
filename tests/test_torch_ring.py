"""Port parity of ring attention on the CPU: ``veles_tpu_torch.parallel.
ring_attention`` in spawned gloo worlds of 2 and 4 ranks against the
JAX package's ``ring_attention_sharded`` on the conftest's virtual CPU
devices, forward and gradients, causal and not, on the same numpy
inputs at f32.

Tolerance: 1e-4 of each result's scale (the bound the JAX package's
multichip dry run holds its meshed runs to). The port's hops are the
flash core's blocked forward and backward with the merged statistics;
the reference accumulates per hop: both are exact attention, so they
differ in summation order only (f32 noise, ~1e-6 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from veles_tpu.parallel.mesh import MeshConfig as JMeshConfig
from veles_tpu.parallel.mesh import make_mesh as jmake_mesh
from veles_tpu.parallel.ring_attention import (attention_reference as
                                               jattention_reference)
from veles_tpu.parallel.ring_attention import ring_attention_sharded
from veles_tpu_torch.parallel import multiprocess as mp

torch.set_num_threads(1)

TOL = 1e-4
SHAPE = (2, 32, 2, 16)        # [B, T, H, D]: T splits 2 and 4 ways
WORLD_TIMEOUT_S = 180


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _cases(n):
    """(name, mesh config, causal, q, k, v, do) of a world of n ranks:
    the ring over all n ranks, and at 4 a ring of 2 inside data=2."""
    cases = []
    for causal in (True, False):
        cases.append(("seq%d_%s" % (n, "causal" if causal else "full"),
                      dict(seq=n), causal) + tuple(_inputs(n + causal)))
    if n == 4:
        cases.append(("data2_seq2_causal", dict(data=2, seq=2), True)
                     + tuple(_inputs(9)))
    return cases


def _reference(cfg, causal, q, k, v, do):
    n = cfg.get("data", 1) * cfg["seq"]
    mesh = jmake_mesh(jax.devices()[:n], JMeshConfig(**cfg))

    def loss(q, k, v):
        return jnp.sum(ring_attention_sharded(q, k, v, mesh, "seq",
                                              causal) * do)

    out = ring_attention_sharded(q, k, v, mesh, "seq", causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    cases = _cases(n)
    port = mp.run_world(W.ring_world, n, "gloo", "cpu", args=(cases,),
                        timeout_s=WORLD_TIMEOUT_S, threads=1)[0]
    ref = {c[0]: _reference(*c[1:]) for c in cases}
    return n, cases, port, ref


@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_ring_matches_reference(world, what):
    n, cases, port, ref = world
    idx = ["out", "dq", "dk", "dv"].index(what)
    for name, *_ in cases:
        assert _rel(port[name][idx], ref[name][idx]) <= TOL, (name, what)


def test_ring_without_an_axis_is_flash_attention(world):
    _, cases, port, _ = world
    q, k, v = cases[0][3:6]
    want = np.asarray(jattention_reference(q, k, v, causal=True))
    assert _rel(port["local_no_axis"], want) <= TOL
    assert _rel(port["dense"], want) <= TOL
