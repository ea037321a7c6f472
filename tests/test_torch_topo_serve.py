"""The served topology workload and the sweep jobs of the PyTorch port
against ``freedm_tpu.serve.service`` and ``freedm_tpu.scenarios.jobs``
(CPU, float64; the AC verify's ``precision="auto"`` is f64 on the CPU in
both packages):

- ``POST /v1/topo`` through ``Service.request``: the round trip and its
  exact accounting, a variant count below the top-k cap, the ranking of
  the sweep, the typed validation errors, radial mode, and the shortlist
  and counts of the reference's service for each objective (``violations``
  ties often: the stable sort keeps ``lax.top_k``'s lower index first);
- the serving cache's B′ LU adopted by the engine (tensor identity, no
  second ``lu_factor``), and a cache-off engine factorizing its own;
- ``POST /v1/topo/sweep`` through ``JobManager.submit_topo``: the
  reference's parser (accepted specs, refusals and messages, bounds),
  the job lifecycle with its checkpoint file, cancel and resume, a crash
  requeued, and the HTTP routes; the ``--topo-*`` flags.
"""

import http.client
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from freedm_tpu.scenarios import jobs as ref_jobs
from freedm_tpu.serve import InvalidRequest as RefInvalidRequest
from freedm_tpu.serve import ServeConfig as RefServeConfig
from freedm_tpu.serve import Service as RefService
from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.grid.matpower import load_builtin
from freedm_tpu_torch.pf import topo as tp
from freedm_tpu_torch.pf.n1 import secure_outages
from freedm_tpu_torch.scenarios import jobs
from freedm_tpu_torch.scenarios.jobs import JobManager
from freedm_tpu_torch.serve.queue import InvalidRequest, NotFound
from freedm_tpu_torch.serve.service import ServeConfig, Service

REPO = Path(__file__).resolve().parent.parent
CFG = dict(max_batch=4, buckets=(1, 4), topo_top_k=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def service():
    svc = Service(ServeConfig(device="cpu", **CFG))
    yield svc
    svc.stop()


@pytest.fixture(scope="module")
def reference():
    svc = RefService(RefServeConfig(**CFG))
    yield svc
    svc.stop()


def _bridges(case="case14"):
    sys_ = load_builtin(case)
    return set(range(sys_.n_branch)) - set(secure_outages(sys_))


# ---------------------------------------------------------------------------
# POST /v1/topo
# ---------------------------------------------------------------------------


def test_sync_roundtrip_and_accounting(service):
    resp = service.request("topo", {"case": "case14", "max_rank": 2,
                                    "top_k": 3, "timeout_s": 300})
    assert resp.workload == "topo" and resp.n_variants == 210
    assert (resp.n_feasible + resp.n_disconnected + resp.n_nonradial
            + resp.n_islanded) == resp.n_variants
    assert resp.n_disconnected > 0 and resp.n_islanded == 0
    assert resp.shortlist and resp.all_verified
    assert len(resp.shortlist) == 3
    bridges = _bridges()
    for e in resp.shortlist:
        assert not (set(e["open_branches"]) & bridges)
        assert e["ac_converged"] and e["ac_residual_pu"] < 1e-6
    assert set(resp.to_dict()["batch"]) == {"lanes", "bucket", "queue_ms",
                                            "solve_ms", "tier"}


def test_small_variant_count_below_topk_cap(service):
    resp = service.request("topo", {"case": "case14", "switches": [0, 1],
                                    "max_rank": 1, "top_k": 4,
                                    "timeout_s": 300})
    assert resp.n_variants == 2
    assert len(resp.shortlist) == resp.n_feasible == 2
    assert resp.all_verified


def test_sync_matches_sweep_ranking(service):
    resp = service.request("topo", {"case": "case14", "max_rank": 2,
                                    "top_k": 3, "timeout_s": 300})
    sweep = tp.run_topo_sweep(tp.TopoSweepSpec(
        case="case14", max_rank=2, top_k=3, chunk_variants=64,
        ac_verify=False), device="cpu")
    assert ([e["open_branches"] for e in resp.shortlist]
            == [e["open_branches"] for e in sweep["shortlist"]])


@pytest.mark.parametrize("payload", [
    {"case": "case14", "objective": "nope"},
    {"case": "case14", "mode": "nope"},
    {"case": "case14", "max_rank": 99},
    {"case": "case14", "top_k": 99},
    {"case": "case14", "switches": [0, 0]},
    {"case": "case14", "switches": [999]},
    {"case": "case14", "search": "neighborhood", "samples": 0},
    {"case": "case14", "objective": "violations", "flow_limit": 0.0},
    {"case": "case14", "unknown_field": 1},
    {"case": "case14", "max_rank": True},
    {"case": "case14", "flow_limit": float("inf")},
    {"case": "case14", "switches": "0,1"},
    {"case": "case14", "max_rank": 3},  # over --topo-max-rank
    {"case": "mesh118", "max_rank": 2, "switches": list(range(236))},
])
def test_validation_typed_errors(service, reference, payload):
    with pytest.raises(RefInvalidRequest) as want:
        reference.request("topo", dict(payload))
    with pytest.raises(InvalidRequest) as got:
        service.request("topo", dict(payload))
    assert got.value.code == "invalid_request"
    assert str(got.value) == str(want.value)


def test_radial_mode_counts_nonradial(service):
    resp = service.request("topo", {"case": "case14", "max_rank": 1,
                                    "mode": "radial", "timeout_s": 300})
    # case14 is meshed: opening one branch cannot reach a spanning tree.
    assert resp.n_feasible == 0
    assert (resp.n_nonradial + resp.n_disconnected + resp.n_islanded
            == resp.n_variants)
    assert resp.shortlist == []


@pytest.mark.parametrize("objective,limit", [("violations", 0.3),
                                             ("loss", 1.0),
                                             ("max_flow", 1.0)])
def test_shortlist_equals_the_reference_service(service, reference,
                                                objective, limit):
    body = {"case": "case14", "max_rank": 2, "top_k": 4,
            "objective": objective, "flow_limit": limit, "timeout_s": 300}
    got = service.request("topo", dict(body))
    want = reference.request("topo", dict(body))
    for k in ("n_variants", "n_feasible", "n_islanded", "n_disconnected",
              "n_nonradial", "all_verified"):
        assert getattr(got, k) == getattr(want, k), k
    assert ([e["open_branches"] for e in got.shortlist]
            == [e["open_branches"] for e in want.shortlist])
    for a, b in zip(got.shortlist, want.shortlist):
        assert abs(a["objective"] - b["objective"]) <= 1e-10
        assert abs(a["worst_flow_pu"] - b["worst_flow_pu"]) <= 1e-10
        assert abs(a["v_min_pu"] - b["v_min_pu"]) <= 1e-9
    if objective == "violations":  # the case the tie order decides
        objs = [e["objective"] for e in got.shortlist]
        assert len(set(objs)) < len(objs)


def _count_lu_factor(monkeypatch):
    calls = []
    real = torch.linalg.lu_factor

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(torch.linalg, "lu_factor", counted)
    return calls


def test_engine_adopts_the_cache_entry_lu(monkeypatch):
    svc = Service(ServeConfig(device="cpu", **CFG))
    try:
        assert svc.request("pf", {"case": "case_ieee30"}).converged
        calls = _count_lu_factor(monkeypatch)
        resp = svc.request("topo", {"case": "case_ieee30", "max_rank": 1,
                                    "top_k": 2, "timeout_s": 300})
        assert resp.all_verified
        eng = svc.engine("topo", "case_ieee30")
        entry = svc.cache.entry("case_ieee30", eng._sys, "dense")
        assert eng._lu is entry.precond.bp  # the entry's own tensors
        n = eng._sys.n_bus
        assert (n, n) not in calls  # no second B′ factorization
    finally:
        svc.stop()


def test_cache_off_engine_factorizes_b_prime_itself(monkeypatch):
    svc = Service(ServeConfig(device="cpu", cache_mb=0.0, **CFG))
    try:
        calls = _count_lu_factor(monkeypatch)
        resp = svc.request("topo", {"case": "case_ieee30", "max_rank": 1,
                                    "top_k": 2, "timeout_s": 300})
        assert resp.all_verified
        assert svc.engine("topo", "case_ieee30")._lu is None
        assert calls.count((30, 30)) >= 1
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# POST /v1/topo/sweep
# ---------------------------------------------------------------------------


def test_bounds_and_config_match_reference():
    for name in ("MAX_TOPO_JOB_VARIANTS", "MAX_TOPO_JOB_TOPK",
                 "MIN_TOPO_CHUNK", "MAX_TOPO_CHUNK"):
        assert getattr(jobs, name) == getattr(ref_jobs, name), name
    assert jobs._TOPO_FIELDS == ref_jobs._TOPO_FIELDS
    for name in ("topo_max_rank", "topo_max_variants", "topo_top_k"):
        assert (getattr(ServeConfig(), name)
                == getattr(RefServeConfig(), name)), name
    assert (JobManager(device="cpu").default_topo_chunk
            == ref_jobs.JobManager().default_topo_chunk)


@pytest.mark.parametrize("payload", [
    {"case": "case14"},
    {"case": "mesh118", "max_rank": 3, "search": "neighborhood",
     "samples": 5000, "seed": 7, "chunk_variants": 1024, "job_key": "a.b"},
    {"case": "case_ieee30", "switches": [3, 1, 7], "mode": "radial",
     "objective": "violations", "flow_limit": 2, "top_k": 32,
     "ac_verify": False, "mesh_devices": 1},
])
def test_parse_accepts_what_the_reference_accepts(payload):
    spec, key, total = jobs.parse_topo_job_request(dict(payload))
    rspec, rkey, rtotal = ref_jobs.parse_topo_job_request(dict(payload))
    assert spec.to_dict() == rspec.to_dict()
    assert (key, total) == (rkey, rtotal)
    assert tp.TopoSweepSpec.from_dict(spec.to_dict()) == spec


@pytest.mark.parametrize("bad", [
    "not-a-dict",
    {"max_rank": 2},
    {"case": "case14", "bogus": 1},
    {"case": "case14", "objective": "nope"},
    {"case": "case14", "chunk_variants": 1},
    {"case": "case14", "top_k": 33},
    {"case": "case14", "max_rank": 7},
    {"case": "case14", "flow_limit": "1"},
    {"case": "case14", "ac_verify": 1},
    {"case": "case14", "switches": [1, True]},
    {"case": "case14", "switches": [1, 1]},
    {"case": "case14", "job_key": "../x"},
    {"case": "nope"},
    {"case": "mesh2000", "max_rank": 2},  # 8M variants: over the ceiling
])
def test_parse_refusals_match_reference(bad):
    with pytest.raises(RefInvalidRequest) as want:
        ref_jobs.parse_topo_job_request(bad)
    with pytest.raises(InvalidRequest) as got:
        jobs.parse_topo_job_request(bad)
    assert str(got.value) == str(want.value)


def _wait_terminal(jm, job_id, timeout_s=240.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        j = jm.get(job_id)
        if j["state"] in ("completed", "failed", "cancelled"):
            return j
        time.sleep(0.05)
    return jm.get(job_id)


def test_job_lifecycle_and_resume_metadata(tmp_path):
    completed = obs.TOPO_SWEEPS.labels("completed").value
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    try:
        out = jm.submit_topo({"case": "case14", "max_rank": 2,
                              "chunk_variants": 64, "job_key": "t1",
                              "ac_verify": False})
        assert out["kind"] == "topo" and out["state"] == "queued"
        assert out["chunks_total"] == 4
        j = _wait_terminal(jm, out["job_id"])
        assert j["state"] == "completed", j
        assert j["summary"]["variants_total"] == 210
        assert j["chunks_done"] == j["chunks_total"] == 4
        assert (tmp_path / "topo_t1.json").exists()
        # The worker counts the outcome just after it publishes the state.
        deadline = time.monotonic() + 10
        while (obs.TOPO_SWEEPS.labels("completed").value < completed + 1
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert obs.TOPO_SWEEPS.labels("completed").value == completed + 1
        with pytest.raises(NotFound):
            jm.get("nope")
        with pytest.raises(InvalidRequest):
            jm.submit_topo({"case": "case14", "objective": "nope"})
        with pytest.raises(InvalidRequest):
            jm.submit_topo({"case": "case14", "bogus": 1})
        with pytest.raises(InvalidRequest):
            jm.submit_topo({"case": "case14", "chunk_variants": 1})
    finally:
        jm.stop()


def _patched_sweep(monkeypatch, hook):
    """Route the manager's sweeps through ``hook(done)`` after each
    chunk's checkpoint."""
    real = jobs.run_topo_sweep

    def run(spec, **kw):
        on_chunk = kw["on_chunk"]

        def wrapped(done, total, chunk_s, real_lanes):
            on_chunk(done, total, chunk_s, real_lanes)
            hook(done)

        kw["on_chunk"] = wrapped
        return real(spec, **kw)

    monkeypatch.setattr(jobs, "run_topo_sweep", run)


def test_cancel_mid_sweep_and_resubmit_resumes(tmp_path, monkeypatch):
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    ids = []
    known = threading.Event()

    def cancel_after_first(done):
        if done == 1:  # the resubmission resumes at chunk 2
            assert known.wait(30)
            jm.cancel(ids[0])

    _patched_sweep(monkeypatch, cancel_after_first)
    payload = {"case": "case14", "max_rank": 2, "chunk_variants": 64,
               "job_key": "c1", "ac_verify": False}
    try:
        ids.append(jm.submit_topo(payload)["job_id"])
        known.set()
        j = _wait_terminal(jm, ids[0])
        assert j["state"] == "cancelled" and j["chunks_done"] == 1
        assert (tmp_path / "topo_c1.json").exists()
        ids.append(jm.submit_topo(payload)["job_id"])
        j2 = _wait_terminal(jm, ids[1])
        assert j2["state"] == "completed" and j2["resumed_from_chunk"] == 1
        spec, _, _ = jobs.parse_topo_job_request(payload)
        want = tp.run_topo_sweep(spec, device="cpu")
        assert (tp.strip_topo_timing(j2["summary"])
                == tp.strip_topo_timing(want))
    finally:
        jm.stop()


def test_worker_crash_requeues_the_sweep(tmp_path, monkeypatch):
    crashes = []

    def crash_once(done):
        if done == 1 and not crashes:
            crashes.append(done)
            raise RuntimeError("worker died after its first checkpoint")

    _patched_sweep(monkeypatch, crash_once)
    requeued = obs.TOPO_REQUEUED.value
    resumes = obs.TOPO_RESUMES.value
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    try:
        j = _wait_terminal(jm, jm.submit_topo({
            "case": "case14", "max_rank": 2, "chunk_variants": 64,
            "job_key": "rq", "ac_verify": False})["job_id"])
        assert j["state"] == "completed", j.get("error")
        assert j["requeues"] == 1 and j["resumed_from_chunk"] == 1
        assert obs.TOPO_REQUEUED.value == requeued + 1
        assert obs.TOPO_RESUMES.value == resumes + 1
    finally:
        jm.stop()


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_topo_http_routes(tmp_path):
    from freedm_tpu_torch.serve.http import ServeServer

    svc = Service(ServeConfig(device="cpu", **CFG))
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    srv = ServeServer(svc, port=0, jobs=jm).start()
    try:
        status, d = _call(srv.port, "POST", "/v1/topo",
                          {"case": "case14", "max_rank": 1, "top_k": 2,
                           "timeout_s": 300})
        assert status == 200 and d["workload"] == "topo"
        assert d["n_variants"] == 20 and len(d["shortlist"]) == 2
        status, e = _call(srv.port, "POST", "/v1/topo",
                          {"case": "case14", "mode": "tree"})
        assert status == 400 and e["error"]["type"] == "invalid_request"
        status, job = _call(srv.port, "POST", "/v1/topo/sweep",
                            {"case": "case14", "max_rank": 1,
                             "chunk_variants": 64, "top_k": 2})
        assert status == 202 and job["kind"] == "topo"
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            status, j = _call(srv.port, "GET", f"/v1/jobs/{job['job_id']}")
            assert status == 200
            if j["state"] in ("completed", "failed", "cancelled"):
                break
            time.sleep(0.05)
        assert j["state"] == "completed", j.get("error")
        assert j["kind"] == "topo" and j["summary"]["variants_total"] == 20
        assert ([e["open_branches"] for e in j["summary"]["shortlist"]]
                == [e["open_branches"] for e in d["shortlist"]])
        status, e = _call(srv.port, "POST", "/v1/topo/sweep",
                          {"case": "case14", "max_rank": 9})
        assert status == 400 and e["error"]["type"] == "invalid_request"
        status, h = _call(srv.port, "GET", "/healthz")
        assert "topo" in h["workloads"]
    finally:
        srv.stop()
        jm.stop()
        svc.stop()


def test_serve_cli_has_the_topo_flags():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-m", "freedm_tpu_torch", "serve",
                          "--help"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--topo-max-rank", "--topo-max-variants", "--topo-top-k",
                 "--topo-chunk-variants"):
        assert flag in out.stdout, flag
