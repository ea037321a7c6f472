"""The port's QSTS jobs API against ``freedm_tpu.scenarios.jobs``:
``parse_job_request`` refuses the reference's bad payloads with the same
typed errors and messages (the agents bounds too); ``JobManager``'s
lifecycle, resume, cancel, failures and crash requeue; the HTTP routes
(``POST /v1/qsts``, ``GET /v1/jobs/<id>``, ``POST /v1/jobs/<id>/cancel``)
on ``device="cpu"``; the ``--qsts-*`` flags."""

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
from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.scenarios import jobs
from freedm_tpu_torch.scenarios.engine import StudySpec, run_study, strip_timing
from freedm_tpu_torch.scenarios.jobs import JobManager, parse_job_request
from freedm_tpu_torch.serve.queue import InvalidRequest, NotFound

REPO = Path(__file__).resolve().parent.parent
FEEDER_JOB = {"case": "vvc_9bus", "scenarios": 2, "steps": 4,
              "chunk_steps": 2, "dt_minutes": 60.0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is many small ops; on a shared host a
    multi-threaded pool spends longer waking its threads than computing,
    so these tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_bounds_match_reference():
    for name in ("MAX_SCENARIOS", "MAX_STEPS", "MAX_CHUNK_STEPS",
                 "MAX_LANE_CELLS", "DEFAULT_AGENTS_MAX",
                 "DEFAULT_AGENTS_CELLS_MAX"):
        assert getattr(jobs, name) == getattr(ref_jobs, name), name
    assert jobs._FIELDS == ref_jobs._FIELDS
    assert JobManager.MAX_TABLE == ref_jobs.JobManager.MAX_TABLE
    assert JobManager.MAX_REQUEUES == ref_jobs.JobManager.MAX_REQUEUES


def test_parse_job_request_accepts_what_the_reference_accepts():
    for payload in ({"case": "case14", "scenarios": 2, "job_key": "a-b.c_1"},
                    {"case": "mesh118", "pf_backend": "sparse",
                     "mesh_devices": 1, "agents": {"ev": 5, "dr": 2}},
                    dict(FEEDER_JOB, warm_start=False, profile="mixed")):
        spec, key = parse_job_request(dict(payload))
        rspec, rkey = ref_jobs.parse_job_request(dict(payload))
        assert spec.to_dict() == rspec.to_dict() and key == rkey
    spec, _ = parse_job_request({"case": "case14"}, default_chunk_steps=7)
    assert spec.chunk_steps == 7
    assert StudySpec.from_dict(spec.to_dict()) == spec


@pytest.mark.parametrize("bad", [
    "not-a-dict",
    {"scenarios": 2},  # missing case
    {"case": "case14", "frobnicate": 1},  # unknown field
    {"case": "case14", "scenarios": 0},
    {"case": "case14", "scenarios": "many"},
    {"case": "case14", "steps": 10**9},
    {"case": "case14", "dt_minutes": -1.0},
    {"case": "case14", "profile": "lunar"},
    {"case": "case14", "warm_start": "yes"},
    {"case": "case14", "job_key": "../escape"},
    {"case": "no_such_case"},
    {"case": "mesh2000", "scenarios": 1024},  # lane-cell ceiling
    {"case": "", "scenarios": 2},
    {"case": "case14", "max_iter": 0},
    {"case": "case14", "pf_backend": "banded"},
    {"case": "case14", "pf_precision": "bf16"},
    {"case": "mesh4001"},
    {"case": "vvc_9bus", "scenarios": 2, "agents": {"ev": 5}},
    {"case": "case14", "agents": {"ev": 0}},
    {"case": "case14", "agents": {"ev": 2_000_000}},
    {"case": "case14", "scenarios": 8, "agents": {"ev": 600_000}},
    {"case": "case14", "agents": []},
])
def test_parse_job_request_refusals_match_reference(bad):
    with pytest.raises(RefInvalidRequest) as want:
        ref_jobs.parse_job_request(bad)
    with pytest.raises(InvalidRequest) as got:
        parse_job_request(bad)
    assert str(got.value) == str(want.value)
    assert got.value.code == "invalid_request"


def test_sharded_and_topo_jobs_are_refused():
    with pytest.raises(InvalidRequest, match="item 16"):
        parse_job_request({"case": "case14", "mesh_devices": 4})
    # Topology sweep jobs are ported: a sharded one is refused like a
    # sharded study, an invalid one with the reference's typed error.
    with pytest.raises(InvalidRequest, match="item 16"):
        jobs.parse_topo_job_request({"case": "case14", "mesh_devices": 4})
    with pytest.raises(InvalidRequest, match="objective"):
        JobManager(device="cpu").submit_topo({"case": "case14",
                                              "objective": "nope"})
    spec, key, total = jobs.parse_topo_job_request({"case": "case14",
                                                    "mesh_devices": 1})
    assert (spec.max_rank, key, total) == (2, None, 210)


def _wait_terminal(jm, job_id, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        j = jm.get(job_id)
        if j["state"] in ("completed", "failed", "cancelled"):
            return j
        time.sleep(0.05)
    return jm.get(job_id)


def test_job_manager_lifecycle_resume_and_cancel(tmp_path):
    submitted = obs.QSTS_SUBMITTED.value
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    try:
        payload = dict(FEEDER_JOB, job_key="t1")
        d = jm.submit(payload)
        assert d["state"] == "queued" and d["chunks_total"] == 2
        j = _wait_terminal(jm, d["job_id"])
        assert j["state"] == "completed", j.get("error")
        assert j["summary"]["energy_balance_ok"]
        assert (tmp_path / "qsts_t1.json").exists()
        # Resubmitting the identical keyed spec resumes (here: from the
        # final chunk — the summary must match the first run exactly).
        j2 = _wait_terminal(jm, jm.submit(payload)["job_id"])
        assert j2["state"] == "completed"
        assert j2["summary"]["resumed_from_chunk"] == 2
        assert strip_timing(j2["summary"]) == strip_timing(j["summary"])
        with pytest.raises(NotFound):
            jm.get("nope")
        with pytest.raises(NotFound):
            jm.cancel("nope")
        # Cancelling a terminal job is a no-op on its state.
        assert jm.cancel(j2["job_id"])["state"] == "completed"
        assert obs.QSTS_SUBMITTED.value == submitted + 2
        stats = jm.stats()
        assert stats["by_state"]["completed"] >= 2 and stats["workers"] == 1
        snap = jm.snapshot_state()
        assert snap["total"] == sum(snap["by_state"].values())
        assert not jm.busy() and jm.progress_age() == 0.0
    finally:
        jm.stop()


def test_queued_job_cancels_inline():
    jm = JobManager(workers=1, device="cpu")  # not started: stays queued
    cancelled = obs.QSTS_JOBS.labels("cancelled").value
    job = jm.submit({"case": "case14", "scenarios": 2, "steps": 4})
    out = jm.cancel(job["job_id"])
    assert out["state"] == "cancelled" and "finished_ts" in out
    assert obs.QSTS_JOBS.labels("cancelled").value == cancelled + 1
    jm.stop()
    from freedm_tpu_torch.serve.queue import ShuttingDown

    with pytest.raises(ShuttingDown):
        jm.submit({"case": "case14"})


def _patched_run_study(monkeypatch, hook):
    """Route the manager's studies through ``hook(done, rec_spec)`` after
    each chunk's checkpoint (the callback runs after the write)."""
    real = jobs.run_study

    def run(spec, **kw):
        on_chunk = kw["on_chunk"]

        def wrapped(done, total, chunk_s, lane_steps):
            on_chunk(done, total, chunk_s, lane_steps)
            hook(done, spec)

        kw["on_chunk"] = wrapped
        return real(spec, **kw)

    monkeypatch.setattr(jobs, "run_study", run)


def test_cancel_mid_run_keeps_checkpoint_and_resubmit_resumes(tmp_path,
                                                              monkeypatch):
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    ids = []
    known = threading.Event()

    def cancel_after_first(done, spec):
        if done == 1:  # the resubmission resumes at chunk 2
            assert known.wait(30)  # the first job's id is recorded
            jm.cancel(ids[0])

    _patched_run_study(monkeypatch, cancel_after_first)
    try:
        payload = dict(FEEDER_JOB, steps=6, job_key="c1")
        ids.append(jm.submit(payload)["job_id"])
        known.set()
        j = _wait_terminal(jm, ids[0])
        assert j["state"] == "cancelled" and j["chunks_done"] == 1
        assert (tmp_path / "qsts_c1.json").exists()
        ids.append(jm.submit(payload)["job_id"])
        j2 = _wait_terminal(jm, ids[1])
        assert j2["state"] == "completed"
        assert j2["resumed_from_chunk"] == 1
        spec, _ = parse_job_request(payload)
        want = run_study(spec, device="cpu")
        assert strip_timing(j2["summary"]) == strip_timing(want)
    finally:
        jm.stop()


def test_worker_crash_requeues_and_resumes(tmp_path, monkeypatch):
    crashes = []

    def crash_once(done, spec):
        if done == 1 and not crashes:
            crashes.append(done)
            raise RuntimeError("worker died after its first checkpoint")

    _patched_run_study(monkeypatch, crash_once)
    requeued = obs.QSTS_REQUEUED.value
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    try:
        payload = dict(FEEDER_JOB, steps=6, job_key="rq")
        j = _wait_terminal(jm, jm.submit(payload)["job_id"])
        assert j["state"] == "completed", j.get("error")
        assert j["requeues"] == 1 and "error" not in j
        assert j["summary"]["resumed_from_chunk"] == 1
        assert obs.QSTS_REQUEUED.value == requeued + 1
        spec, _ = parse_job_request(payload)
        want = run_study(spec, device="cpu")
        assert strip_timing(j["summary"]) == strip_timing(want)
    finally:
        jm.stop()


def test_failing_study_surfaces_as_failed(tmp_path, monkeypatch):
    def always(done, spec):
        raise RuntimeError("deterministic failure")

    _patched_run_study(monkeypatch, always)
    failed = obs.QSTS_JOBS.labels("failed").value
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    try:
        # Unkeyed: no checkpoint to resume from, so no requeue.
        j = _wait_terminal(jm, jm.submit(dict(FEEDER_JOB))["job_id"])
        assert j["state"] == "failed" and j["requeues"] == 0
        assert "deterministic failure" in j["error"]
        # Keyed: each requeue resumes one chunk further and crashes
        # again; after MAX_REQUEUES the job is failed (4 chunks: the
        # third crash is terminal).
        j = _wait_terminal(jm, jm.submit(dict(FEEDER_JOB, steps=8,
                                              job_key="f"))["job_id"])
        assert j["state"] == "failed"
        assert j["requeues"] == JobManager.MAX_REQUEUES
        assert obs.QSTS_JOBS.labels("failed").value == failed + 2
    finally:
        jm.stop()


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=None if body is None
                 else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read() or b"null")
    conn.close()
    return resp.status, data


def test_jobs_http_roundtrip(tmp_path):
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    svc = Service(ServeConfig(max_batch=2, buckets=(1, 2), device="cpu"),
                  start=False)
    jm = JobManager(workers=1, checkpoint_dir=str(tmp_path),
                    device="cpu").start()
    srv = ServeServer(svc, port=0, jobs=jm).start()
    bare = ServeServer(svc, port=0).start()
    try:
        status, d = _call(srv.port, "POST", "/v1/qsts",
                          dict(FEEDER_JOB, job_key="h1"))
        assert status == 202 and d["state"] == "queued"
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            status, j = _call(srv.port, "GET", f"/v1/jobs/{d['job_id']}")
            assert status == 200
            if j["state"] in ("completed", "failed"):
                break
            time.sleep(0.05)
        assert j["state"] == "completed", j.get("error")
        assert j["summary"]["lane_steps_not_converged"] == 0
        status, c = _call(srv.port, "POST", f"/v1/jobs/{d['job_id']}/cancel",
                          {})
        assert status == 200 and c["state"] == "completed"
        status, e = _call(srv.port, "GET", "/v1/jobs/deadbeef")
        assert status == 404 and e["error"]["type"] == "not_found"
        status, e = _call(srv.port, "POST", "/v1/qsts", {"case": "nope"})
        assert status == 400 and e["error"]["type"] == "invalid_request"
        status, e = _call(srv.port, "POST", "/v1/topo/sweep",
                          {"case": "case14", "objective": "nope"})
        assert status == 400 and e["error"]["type"] == "invalid_request"
        status, h = _call(srv.port, "GET", "/healthz")
        assert status == 200 and h["qsts"] is True
        status, s = _call(srv.port, "GET", "/stats")
        assert status == 200 and s["qsts"]["by_state"]["completed"] == 1
        # A server without a job manager answers the reference's 404.
        status, e = _call(bare.port, "POST", "/v1/qsts", FEEDER_JOB)
        assert status == 404
        assert e["error"]["detail"] == ("QSTS jobs are not enabled on this "
                                        "server")
        status, h = _call(bare.port, "GET", "/healthz")
        assert h["qsts"] is False
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        assert "qsts_jobs_total" in text and "qsts_chunk_seconds" in text
    finally:
        bare.stop()
        srv.stop()
        jm.stop()
        svc.stop()


def test_concurrent_submissions_stay_within_the_queue_bound():
    jm = JobManager(workers=1, max_pending=3, device="cpu")  # not started
    from freedm_tpu_torch.serve.queue import Overloaded

    results = []

    def submit():
        try:
            jm.submit({"case": "case14", "scenarios": 1, "steps": 1})
            results.append("ok")
        except Overloaded:
            results.append("shed")

    threads = [threading.Thread(target=submit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert results.count("ok") == 3 and results.count("shed") == 5
    assert jm.stats()["pending"] == 3
    jm.stop(timeout=1)


def test_serve_cli_has_the_qsts_flags():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-m", "freedm_tpu_torch", "serve",
                          "--help"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--qsts-workers", "--qsts-max-jobs", "--qsts-chunk-steps",
                 "--qsts-checkpoint-dir", "--qsts-agents-max",
                 "--qsts-agents-cells-max"):
        assert flag in out.stdout, flag
