"""The port's REST serving (``veles_tpu_torch.restful_api``) against the
JAX package's, on the CPU, and ``ServeServer(path=...)``.

Both modes of ``RESTfulAPI`` answer ``POST <path>`` with the same rows
as the reference's ``RESTfulAPI`` over the same weights (the two
packages draw the initial weights bitwise equal from the same seed;
the test checks that first): engine mode (``for_workflow``, the
engine's bucketed forward behind a micro-batcher) and loader-graph
mode (``RestfulLoader`` -> forward -> ``RESTfulAPI.run``). Bound: 1e-4
of the outputs' scale at f32 (the frameworks differ in summation order
only). Malformed bodies get 400 in both modes.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.memory as R_memory
import veles_tpu.models.mnist as R_mnist
import veles_tpu.nn as R_nn
import veles_tpu.prng as R_prng
import veles_tpu.restful_api as R_restful
import veles_tpu.workflow as R_workflow
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.memory as P_memory
import veles_tpu_torch.models.mnist as P_mnist
import veles_tpu_torch.nn as P_nn
import veles_tpu_torch.prng as P_prng
import veles_tpu_torch.restful_api as P_restful
import veles_tpu_torch.workflow as P_workflow

torch.set_num_threads(1)

TOL = 1e-4
REF = dict(backends=R_backends, memory=R_memory, mnist=R_mnist, nn=R_nn,
           restful=R_restful, workflow=R_workflow)
PORT = dict(backends=P_backends, memory=P_memory, mnist=P_mnist, nn=P_nn,
            restful=P_restful, workflow=P_workflow)
MNIST = dict(layers=(32, 10), max_epochs=1,
             loader_kwargs={"n_train": 60, "n_valid": 20,
                            "minibatch_size": 20})


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 23
    R_prng.reset()
    P_prng.reset()
    yield
    for c, (dtype, seed) in zip((R_config, P_config), saved):
        c.root.common.engine.compute_type = dtype
        c.root.common.random.seed = seed
    R_prng.reset()
    P_prng.reset()


def _post(url, doc):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _host(array):
    return np.asarray(array.map_read(), dtype=np.float32)


def _rows(n, width, seed):
    return np.random.default_rng(seed).random((n, width)).astype(
        np.float32)


def _engine_api(mods):
    wf = mods["mnist"].MnistWorkflow(**MNIST)
    wf.initialize(device=mods["backends"].Device(backend="cpu"))
    api = mods["restful"].RESTfulAPI.for_workflow(wf, max_delay_ms=1.0)
    assert api.initialize() is None
    return wf, api


def test_engine_mode_matches_reference():
    """``RESTfulAPI.for_workflow`` of the same initial MnistWorkflow in
    both packages: the same posted rows (one request and a batch of
    requests of different sizes) answer the same outputs within 1e-4."""
    served = []
    for mods in (REF, PORT):
        wf, api = _engine_api(mods)
        try:
            weights = [_host(u.weights) for u in wf.forwards]
            outs = []
            for i, n in enumerate((1, 3, 7)):
                code, doc = _post(api.url, {"input": _rows(
                    n, 784, i).reshape(n, 28, 28).tolist()})
                assert code == 200, doc
                outs.append(np.asarray(doc["output"], np.float32))
            for bad in ({"input": []}, {"input": [1.0, 2.0]},
                        {"inputs": [[0.0]]}):
                assert _post(api.url, bad)[0] == 400
            served.append((weights, outs))
        finally:
            api.stop()
            wf.thread_pool.shutdown()
    (ref_w, ref_out), (port_w, port_out) = served
    for a, b in zip(port_w, ref_w):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port_out, ref_out):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL


def test_engine_mode_serves_on_the_workflows_device():
    """for_workflow builds the engine on the device the workflow was
    initialized on (here the CPU); the default route is /apply."""
    wf, api = _engine_api(PORT)
    try:
        assert api.engine_.device == torch.device("cpu")
        assert api.url.endswith(":%d/apply" % api.endpoint[1])
        assert api.metrics is not None
    finally:
        api.stop()
        wf.thread_pool.shutdown()


def _graph(mods, path="/apply"):
    wf = mods["workflow"].Workflow()
    wf.thread_pool = None
    device = mods["backends"].Device(backend="cpu")
    loader = mods["restful"].RestfulLoader(wf, sample_shape=(4,),
                                           minibatch_size=3)
    assert loader.initialize(device=device) is None
    loader.minibatch_data.initialize(device)
    fc = mods["nn"].All2AllTanh(wf, output_sample_shape=2)
    fc.input = loader.minibatch_data
    assert fc.initialize(device=device) is None
    api = mods["restful"].RESTfulAPI(wf, path=path)
    api.output = fc.output
    api.loader = loader
    assert api.initialize() is None
    stop = threading.Event()

    def loop():
        while not stop.is_set() and not loader.complete:
            loader.run()
            if loader.minibatch_size == 0:
                continue
            fc.run()
            api.run()

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()

    def close():
        loader.close()
        stop.set()
        thread.join(timeout=10)
        api.stop()
        assert not thread.is_alive()

    return fc, api, close


def test_loader_graph_mode_matches_reference():
    """RestfulLoader -> All2AllTanh -> RESTfulAPI in both packages:
    requests of 2, 5 and 1 rows (one spans two 3-row minibatches, so
    the FIFO ticket attribution splits it) answer the reference's rows
    within 1e-4; malformed bodies get 400."""
    served = []
    for mods in (REF, PORT):
        fc, api, close = _graph(mods)
        try:
            outs = []
            for i, n in enumerate((2, 5, 1)):
                code, doc = _post(api.url, {"input": _rows(n, 4, 10 + i)
                                            .tolist()})
                assert code == 200, doc
                outs.append(np.asarray(doc["output"], np.float32))
            for bad in ({"input": []}, {"input": [1.0, 2.0]}):
                assert _post(api.url, bad)[0] == 400
            served.append((_host(fc.weights), _host(fc.bias), outs))
        finally:
            close()
    (rw, rb, ref_out), (pw, pb, port_out) = served
    np.testing.assert_array_equal(pw, rw)
    np.testing.assert_array_equal(pb, rb)
    for a, b, n in zip(port_out, ref_out, (2, 5, 1)):
        assert a.shape == b.shape == (n, 2)
        assert _rel(a, b) <= TOL


def test_loader_graph_concurrent_requests_get_their_rows():
    """Eight concurrent requests through the graph loop: every reply
    holds the rows the port's forward computes for that request's
    input (the ticket attribution under interleaving)."""
    fc, api, close = _graph(PORT)
    try:
        w, b = _host(fc.weights), _host(fc.bias)
        results = {}

        def client(i):
            x = _rows(1 + i % 4, 4, 100 + i)
            results[i] = (x, _post(api.url, {"input": x.tolist()}))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 8
        for x, (code, doc) in results.values():
            assert code == 200, doc
            want = 1.7159 * np.tanh(0.6666 * (x @ w + b))
            np.testing.assert_allclose(np.asarray(doc["output"]), want,
                                       rtol=1e-5, atol=1e-5)
    finally:
        close()


def test_restful_api_non_default_path():
    """``RESTfulAPI(path="/predict")`` serves /predict (and the named
    /predict/default), and /apply is not its route any more."""
    fc, api, close = _graph(PORT, path="/predict")
    try:
        assert api.url.endswith("/predict")
        x = _rows(2, 4, 5)
        code, doc = _post(api.url, {"input": x.tolist()})
        assert code == 200 and len(doc["output"]) == 2
        code, _ = _post(api.url + "/default", {"input": x.tolist()})
        assert code == 200
        base = "http://%s:%d" % api.endpoint
        assert _post(base + "/apply", {"input": x.tolist()})[0] == 404
    finally:
        close()


class _Doubler:
    input_dtype = np.float32

    def apply(self, x):
        return np.asarray(x, np.float32) * 2.0


@pytest.mark.parametrize("path", ["/apply", "/apply/v2"])
def test_serve_server_path_through_the_router(path):
    """A ServeServer at a non-default ``path`` (``/apply/v2``) serves
    its default model there, directly and through a RouterServer that
    forwards the request path as it came (the default ``/apply`` for
    comparison)."""
    import time

    from veles_tpu_torch.serve.registry import ModelRegistry
    from veles_tpu_torch.serve.router import RouterServer
    from veles_tpu_torch.serve.server import ServeServer

    registry = ModelRegistry()
    registry.add("default", _Doubler(), max_delay_ms=1.0)
    server = ServeServer(registry, path=path)
    router = RouterServer(health_interval_s=0.05)
    try:
        x = [[1.0, 2.0], [3.0, 4.0]]
        base = "http://%s:%d" % server.endpoint
        code, doc = _post(base + path, {"input": x})
        assert code == 200 and doc["output"] == [[2.0, 4.0], [6.0, 8.0]]
        router.router.add_replica("%s:%d" % server.endpoint)
        deadline = time.monotonic() + 30
        while router.router.routable_count() < 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        front = "http://%s:%d" % router.endpoint
        code, doc = _post(front + path, {"input": x})
        assert code == 200, doc
        assert doc["output"] == [[2.0, 4.0], [6.0, 8.0]]
    finally:
        router.stop()
        server.stop()
