"""Parity of the PyTorch port's ``POST /v1/pf`` service with the JAX one.

The same ``pf`` requests go to the reference
``Service(ServeConfig(..., cache_mb=0.0))`` and to the port's
``Service(ServeConfig(..., cache_mb=0.0, device="cpu"))`` — cold against
cold, with both caches off: convergence flags and iteration counts must
be identical, the balances, voltage extremes and returned states within
1e-9 (float64).  The cache tier is held to the reference in
``tests/test_torch_cache.py``.
"""

import http.client
import json

import numpy as np
import pytest

from freedm_tpu.serve.queue import InvalidRequest as RefInvalidRequest
from freedm_tpu.serve.service import ServeConfig as RefServeConfig
from freedm_tpu.serve.service import Service as RefService
from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.serve.http import ServeServer
from freedm_tpu_torch.serve.queue import InvalidRequest
from freedm_tpu_torch.serve.service import ServeConfig, Service

FIELDS = ("p_balance_pu", "q_balance_pu", "v_min_pu", "v_max_pu")
TOL = 1e-8  # engine tolerance in float64


@pytest.fixture(scope="module")
def services():
    cfg = dict(max_batch=4, max_wait_ms=25.0, queue_depth=64, buckets=(1, 4))
    ref = RefService(RefServeConfig(cache_mb=0.0, **cfg))
    port = Service(ServeConfig(cache_mb=0.0, device="cpu", **cfg))
    yield ref, port
    port.stop()
    ref.stop()


def _assert_same(got, want):
    assert got.converged == want.converged
    assert got.iterations == want.iterations
    for k in FIELDS:
        assert abs(getattr(got, k) - getattr(want, k)) <= 1e-9, k
    assert got.residual_pu < TOL and want.residual_pu < TOL
    if want.v is not None:
        np.testing.assert_allclose(got.v, want.v, atol=1e-9)
        np.testing.assert_allclose(got.theta, want.theta, atol=1e-9)


def _concurrent(svc, reqs):
    """Submit every request before waiting on any (one burst)."""
    futs = [svc.submit("pf", dict(r)) for r in reqs]
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("case", ["case14", "case_ieee30", "mesh40"])
def test_concurrent_requests_match_reference(services, case):
    ref, port = services
    reqs = [{"case": case, "scale": s, "return_state": True}
            for s in (0.8, 1.0, 1.15, 1.3)]
    want = _concurrent(ref, reqs)
    got = _concurrent(port, reqs)
    for g, w in zip(got, want):
        _assert_same(g, w)
        assert g.batch.bucket in (1, 4) and g.batch.tier == "full"
    # Four submits in a burst coalesce: some batch carried > 1 lane.
    assert max(g.batch.lanes for g in got) > 1


def test_warm_start_cuts_iterations_like_the_reference(services):
    ref, port = services
    base = port.request("pf", {"case": "case_ieee30", "scale": 1.1,
                               "return_state": True})
    warm = {"case": "case_ieee30", "scale": 1.12, "v0": base.v,
            "theta0": base.theta, "return_state": True}
    cold = {"case": "case_ieee30", "scale": 1.12}
    before = obs.SERVE_WARM_START.value
    got_w, got_c = port.request("pf", dict(warm)), port.request("pf", cold)
    assert obs.SERVE_WARM_START.value == before + 1
    _assert_same(got_w, ref.request("pf", dict(warm)))
    _assert_same(got_c, ref.request("pf", dict(cold)))
    assert got_w.iterations < got_c.iterations


@pytest.mark.parametrize("payload", [
    {"case": "case14", "bogus": 1},
    {"scale": 1.0},
    {"case": "case14", "scale": 0.0},
    {"case": "case14", "scale": "x"},
    {"case": "case14", "p_inj": [0.0] * 13},
    {"case": "case14", "q_inj": [float("nan")] * 14},
    {"case": "case14", "v0": [5.0] * 14},
    {"case": "case14", "theta0": [10.0] * 14},
    {"case": "nope"},
    {"case": "mesh5000"},
])
def test_validation_errors_are_typed_like_the_reference(services, payload):
    ref, port = services
    with pytest.raises(RefInvalidRequest):
        ref.request("pf", dict(payload))
    with pytest.raises(InvalidRequest) as e:
        port.request("pf", dict(payload))
    assert e.value.code == "invalid_request" and e.value.http_status == 400


def _post(port, path, body, method="POST"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_http_roundtrip_and_typed_errors(services):
    ref, port = services
    server = ServeServer(port).start()
    try:
        status, data = _post(server.port, "/v1/pf",
                             json.dumps({"case": "case14", "scale": 1.05}))
        assert status == 200
        body = json.loads(data)
        want = ref.request("pf", {"case": "case14", "scale": 1.05})
        assert body["converged"] and body["iterations"] == want.iterations
        assert abs(body["p_balance_pu"] - want.p_balance_pu) <= 1e-9
        assert set(body["batch"]) == {"lanes", "bucket", "queue_ms",
                                      "solve_ms", "tier"}

        status, data = _post(server.port, "/v1/pf",
                             json.dumps({"case": "case14", "scale": -1}))
        assert status == 400
        assert json.loads(data)["error"]["type"] == "invalid_request"
        status, data = _post(server.port, "/v1/pf", b"{not json")
        assert status == 400
        status, data = _post(server.port, "/v1/n1",
                             json.dumps({"case": "case14"}))
        assert status == 400  # the n1 workload is served: no outages
        assert json.loads(data)["error"]["type"] == "invalid_request"
        status, data = _post(server.port, "/v1/vvc",
                             json.dumps({"case": "case14"}))
        assert status == 400  # the vvc workload is served: not a feeder
        assert "unknown feeder case" in json.loads(data)["error"]["detail"]
        status, data = _post(server.port, "/v1/topo",
                             json.dumps({"case": "case14", "max_rank": 1,
                                         "top_k": 1}))
        assert status == 200  # the topo workload is served
        assert json.loads(data)["n_variants"] == 20

        status, data = _post(server.port, "/healthz", None, method="GET")
        assert status == 200 and json.loads(data)["device"] == "cpu"
        status, data = _post(server.port, "/stats", None, method="GET")
        stats = json.loads(data)
        assert status == 200 and "pf/case14" in stats["engines"]
        status, data = _post(server.port, "/metrics", None, method="GET")
        assert status == 200 and b"serve_requests_total" in data
    finally:
        server.stop()


def test_unported_configurations_raise_typed_errors():
    with pytest.raises(NotImplementedError, match="mesh_devices"):
        Service(ServeConfig(device="cpu", mesh_devices=4), start=False)
    # The cache tier is ported: cache_mb=64 (the default) builds a cache.
    svc = Service(ServeConfig(device="cpu", cache_mb=64.0), start=False)
    try:
        assert svc.cache is not None
        assert svc.cache.max_bytes == 64 * 1024 * 1024
        assert svc.stats()["cache"]["enabled"] is True
    finally:
        svc.stop()


def test_prewarm_runs_every_bucket_without_counting_recompiles():
    svc = Service(ServeConfig(max_batch=2, buckets=(1, 2), device="cpu",
                              prewarm=("pf/case14",)))
    try:
        stats = svc.stats()
        assert stats["prewarmed"] == ["pf/case14:1", "pf/case14:2"]
        assert stats["recompiles_by_bucket"] == {"pf/case14:1": 0,
                                                 "pf/case14:2": 0}
        assert svc.request("pf", {"case": "case14"}).converged
    finally:
        svc.stop()


def test_serialized_dispatch_matches_the_pipeline():
    """pipeline_depth=0 (one thread: coalesce, solve, scatter inline) is
    the equivalence oracle of the pipelined batcher."""
    reqs = [{"case": "case14", "scale": s, "return_state": True}
            for s in (0.9, 1.0, 1.1)]
    out = []
    for depth in (0, 1):
        # Cache off: with it on, a burst request classified after an
        # earlier one's solve landed would be warm-seeded, in either
        # service at its own timing.  A lane's bits depend on its batch's
        # bucket, so both services must coalesce the same batch: the
        # burst is admitted whole under the queue's (re-entrant) lock
        # before the batcher can take its head, and a long window keeps a
        # busy machine from flushing it early.
        svc = Service(ServeConfig(max_batch=4, buckets=(1, 4), device="cpu",
                                  pipeline_depth=depth, cache_mb=0.0,
                                  max_wait_ms=5000.0))
        try:
            assert bool(svc.batcher.lanes) == (depth > 0)
            with svc.queue._cond:
                futs = [svc.submit("pf", dict(r)) for r in reqs]
            out.append([f.result(timeout=120) for f in futs])
        finally:
            svc.stop()
    for got in out:
        assert [g.batch.lanes for g in got] == [3, 3, 3]
    for a, b in zip(*out):
        assert (a.iterations, a.converged) == (b.iterations, b.converged)
        assert a.v == b.v and a.theta == b.theta
        assert a.p_balance_pu == b.p_balance_pu


def test_unknown_workload_and_route_index_answer_like_the_reference(
        services):
    """``POST /v1/<unknown>`` with a JSON body is the typed 400 of the
    reference's service, and ``GET /`` its route index, listing only the
    routes the port serves."""
    from freedm_tpu.serve.http import ServeServer as RefServeServer

    ref, port = services
    servers = [RefServeServer(ref).start(), ServeServer(port).start()]
    try:
        (ref_s, ref_b), (got_s, got_b) = (
            _post(s.port, "/v1/bogus", json.dumps({"case": "case14"}))
            for s in servers)
        assert ref_s == got_s == 400
        assert json.loads(got_b) == json.loads(ref_b)
        assert json.loads(got_b)["error"] == {
            "type": "invalid_request",
            "detail": "unknown workload 'bogus' (have: pf, n1, vvc, topo)"}
        (ref_s, ref_b), (got_s, got_b) = (_post(s.port, "/", None,
                                                method="GET")
                                          for s in servers)
        assert ref_s == got_s == 200
        want, got = json.loads(ref_b), json.loads(got_b)
        assert set(got) == set(want) == {"service", "post", "get"}
        unported = {"/v1/snapshot", "/provenance"}
        for key in ("post", "get"):
            assert got[key] == [r for r in want[key] if r not in unported]
        for route in got["get"]:
            if "<id>" not in route:
                assert _post(servers[1].port, route, None,
                             method="GET")[0] == 200, route
        status, data = _post(servers[1].port, "/nowhere", b"{}")
        assert status == 404
        assert json.loads(data)["error"]["type"] == "not_found"
    finally:
        for s in servers:
            s.stop()
