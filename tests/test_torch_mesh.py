"""The port's mesh core on the CPU: ``parallel.mesh`` (coordinates and
subgroups), ``parallel.collectives`` (each collective and its
transpose), ``parallel.multiprocess`` (the join, the shards of a host
array) and ``Device.mesh``, in spawned gloo worlds of 2 and 4 ranks
(``data=2 x model=n/2``), and the misuse that must raise.

The collectives move and add small exact values (integers in f32), so
every expected value is exact. One world is spawned a world size; its
results are the cases of the parametrised tests below.
"""

import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from veles_tpu_torch.parallel import multiprocess as mp
from veles_tpu_torch.parallel.mesh import MeshConfig, grid_mesh, make_mesh

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 180


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    return n, mp.run_world(W.mesh_world, n, "gloo", "cpu", args=(n,),
                           timeout_s=WORLD_TIMEOUT_S, threads=1)


def _x(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r


def _w(r):
    return np.arange(1, 7, dtype=np.float32).reshape(2, 3) + r


def _data_slice(n, rank):
    m = n // 2
    return [rank % m, m + rank % m]


def test_mesh_coordinates_and_subgroups(world):
    n, results = world
    m = n // 2
    for rank, out in enumerate(results):
        assert out["count"] == n and out["index"] == rank
        assert out["shape"] == {"data": 2, "model": m}
        assert out["coords"] == {"data": rank // m, "model": rank % m}
        assert out["data_ranks"] == _data_slice(n, rank)
        assert out["model_ranks"] == [rank // m * m + i for i in range(m)]
        assert out["both_size"] == n


def _expected(name, n, rank):
    """(forward, gradient) of ``mesh_world``'s case ``name`` on ``rank``,
    the cotangent on rank s being ``s + 1``."""
    ranks = _data_slice(n, rank)
    i = ranks.index(rank)
    ones = np.ones((2, 3), np.float32)
    if name == "psum":
        return sum(_x(s) for s in ranks), (rank + 1) * ones
    if name == "pvary":
        return _x(rank), sum(s + 1 for s in ranks) * ones
    if name == "gather":
        return (np.concatenate([_x(s) for s in ranks], 1),
                sum(s + 1 for s in ranks) * ones)
    if name == "gather_inv":
        return np.concatenate([_x(s) for s in ranks], 0), (rank + 1) * ones
    if name == "shard":
        grad = np.stack([np.full(3, s + 1, np.float32) for s in ranks], 0)
        return _w(rank)[i:i + 1], grad
    if name == "ppermute":
        src, dst = ranks[(i - 1) % 2], ranks[(i + 1) % 2]
        return _x(src), (dst + 1) * ones
    raise KeyError(name)


@pytest.mark.parametrize("name", ["psum", "pvary", "gather", "gather_inv",
                                  "shard", "ppermute"])
def test_collective_and_its_transpose(world, name):
    n, results = world
    for rank, out in enumerate(results):
        y, grad = out[name]
        want_y, want_grad = _expected(name, n, rank)
        np.testing.assert_array_equal(y, want_y, err_msg=name)
        np.testing.assert_array_equal(grad, want_grad, err_msg=name)


def test_flat_sum_reduce_scatter_and_bf16_bits(world):
    n, results = world
    for rank, out in enumerate(results):
        ranks = _data_slice(n, rank)
        total = sum(_w(s)[:, :2] for s in ranks)
        i = ranks.index(rank)
        np.testing.assert_array_equal(out["scatter"], total[:, i:i + 1])
        x_sum, w_sum, r_sum = out["flat"]
        np.testing.assert_array_equal(x_sum, sum(_x(s) for s in range(n)))
        np.testing.assert_array_equal(w_sum, sum(_w(s)[0] for s in range(n)))
        assert r_sum.tolist() == [float(sum(range(n)))]
        want = torch.cat([torch.from_numpy(_x(s)).to(torch.bfloat16) / 7
                          for s in _data_slice(n, rank)]).float().numpy()
        np.testing.assert_array_equal(out["bf16"], want)


def test_host_shards_and_device_mesh(world):
    n, results = world
    m = n // 2
    host = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    for rank, out in enumerate(results):
        d, c = rank // m, rank % m
        cols = 4 // m
        np.testing.assert_array_equal(
            out["host_to_global"], host[d * 4:(d + 1) * 4,
                                        c * cols:(c + 1) * cols])
        np.testing.assert_array_equal(out["local_batch"], host[:4])
        assert out["device_mesh"] == ({"data": n}, "cpu")
        assert "needs %d ranks, the group has %d" % (n + 1, n) in \
            out["bad_size"]


def test_mesh_without_a_group_raises():
    assert MeshConfig(data=2, seq=4).n_devices == 8
    assert repr(MeshConfig(pipe=2)) == \
        "MeshConfig(data=1, seq=1, model=1, pipe=2)"
    with pytest.raises(RuntimeError, match="joined process group"):
        make_mesh(MeshConfig(data=1), device="cpu")
    with pytest.raises(RuntimeError, match="joined process group"):
        grid_mesh({"data": 1}, device="cpu")
    assert mp.process_count() == 1 and mp.process_index() == 0


def test_initialize_refuses_what_it_cannot_do(monkeypatch):
    """NCCL with two local ranks on one card raises before joining (no
    quiet switch to gloo); so do NCCL on the CPU, an unknown backend and
    a CPU host without ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="refuses two ranks on one card"):
        mp.initialize("127.0.0.1:1", 2, 0, backend="nccl")
    with pytest.raises(ValueError, match="needs backend='gloo'"):
        mp.initialize("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        mp.initialize("127.0.0.1:1", 1, 0, backend="mpi")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.initialize("127.0.0.1:1", 1, 0, backend="gloo")
    assert not mp.is_initialized()


def test_run_world_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        mp.run_world(W.fail_on_rank_1, 2, "gloo", "cpu",
                     timeout_s=WORLD_TIMEOUT_S, threads=1)
