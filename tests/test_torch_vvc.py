"""Gradient Volt-VAR control and the ``vvc`` workload of the PyTorch port
against the JAX package's.

``freedm_tpu_torch`` against ``freedm_tpu`` (CPU, x64) on the same numpy
inputs, float64:

- ``step`` (every field of ``VVCStep``) within 1e-9, with the default
  controller, a ``ctrl_mask``, tight q limits, a given ``alpha0`` and a
  nonzero start; lanes against the reference's ``vmap`` — each lane's
  q, alpha, losses and voltage deltas are the unbatched step's, also
  where lanes accept at different trials;
- ``run_rounds``: q, losses, alphas and flags within 1e-9 over the first
  12 rounds.  Later the two trajectories part: the rounds step at
  ``alpha`` in the thousands on the edge of stability, and each round
  multiplies the last-bit difference of the two libraries' gradients by
  ~2.2 in q (8.4e-13 kvar after 4 rounds, 5.5e-10 after 12, 1.1e-8
  after 16; the losses stay within 2.3e-13 until round 22), so the
  120-round run is held round by round along the reference's trajectory
  (the port's step from the reference's q and alpha each round, within
  1e-9) and to the reference test's contract on its own (non-increasing
  losses, the end below 0.92 of the base, a plateau);
- the ``vvc`` service: ``VVCEngine`` through ``Service(device="cpu")``
  against the reference ``Service`` (loss, base loss, band, flags within
  1e-9), its typed validation errors, ``POST /v1/vvc``, the ``ok``
  counter, prewarm and concurrent requests.

The ``cuda``-marked test holds a controller step on the card (L1 and L2)
to its plain version there.
"""

import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.modules import vvc as ref_vvc
from freedm_tpu.serve.service import ServeConfig as RefServeConfig
from freedm_tpu.serve.service import Service as RefService
from freedm_tpu.utils import cplx as ref_cplx
from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.grid import cases
from freedm_tpu_torch.modules import vvc
from freedm_tpu_torch.pf import ladder
from freedm_tpu_torch.serve.http import ServeServer
from freedm_tpu_torch.serve.queue import InvalidRequest
from freedm_tpu_torch.serve.service import (FEEDER_CASES, V_BAND, ServeConfig,
                                            Service, VVCRequest)

F64 = torch.float64
ATOL = 1e-9
PARITY_ROUNDS = 12
BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module")
def feeders():
    return cases.vvc_9bus(), ref_cases.vvc_9bus()


@pytest.fixture(scope="module")
def s_reactive(feeders):
    # Lagging loads (Q = 0.6 P): the case Volt-VAR control exists for.
    return feeders[0].s_load.real * (1 + 0.6j)


def _assert_step(got, want, atol=ATOL):
    for k in vvc.VVCStep._fields:
        a = getattr(got, k).numpy()
        b = np.asarray(getattr(want, k))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)


def _ctrl(nb):
    ctrl = np.zeros((nb, 3))
    ctrl[4] = 1.0  # node 5 alone is an SST
    return ctrl


STEP_CASES = {
    "default": (dict(), 0.0, None),
    "ctrl_mask": (dict(ctrl_mask="sst5"), 0.0, None),
    "q_limits": (dict(config=vvc.VVCConfig(q_min_kvar=-5.0, q_max_kvar=5.0)),
                 0.0, 2000.0),
    "alpha0": (dict(), 0.0, 3000.0),
    "warm": (dict(), 20.0, 500.0),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_step_matches_reference(feeders, s_reactive, name):
    f, rf = feeders
    kw, q_start, alpha0 = STEP_CASES[name]
    kw = dict(kw)
    if kw.get("ctrl_mask") == "sst5":
        kw["ctrl_mask"] = _ctrl(f.n_branches)
    ref_kw = dict(kw)
    if "config" in kw:
        ref_kw["config"] = ref_vvc.VVCConfig(*kw["config"])
    step = vvc.make_vvc_controller(f, device="cpu", **kw)
    ref_step = ref_vvc.make_vvc_controller(rf, **ref_kw)
    q0 = np.full((f.n_branches, 3), q_start) * (
        kw.get("ctrl_mask", f.phase_mask))
    got = step(s_reactive, q0, alpha0)
    want = ref_step(s_reactive, jnp.asarray(q0), alpha0)
    _assert_step(got, want)
    assert bool(got.improved)
    assert float(got.loss_after_kw) < float(got.loss_before_kw)
    if "ctrl_mask" in kw:
        off = 1.0 - kw["ctrl_mask"]
        assert float((got.q_ctrl_kvar * torch.tensor(off)).abs().max()) == 0


def test_lanes_match_reference_vmap(feeders, s_reactive):
    f, rf = feeders
    step = vvc.make_vvc_controller(f, device="cpu")
    ref_step = ref_vvc.make_vvc_controller(rf)
    scales = np.linspace(0.5, 1.2, 6)
    q0 = np.zeros((f.n_branches, 3))
    # A start far too large: the lanes accept after different numbers of
    # halvings, and a lane that accepted must freeze while others go on.
    alpha0 = np.array([1.0, 5e4, 2e5, 1e6, 3e3, 8e5])
    got = step(scales[:, None, None] * s_reactive[None], q0, alpha0)
    sc = ref_cplx.as_c(s_reactive)
    want = jax.vmap(lambda k, a: ref_step(
        ref_cplx.C(sc.re * k, sc.im * k), jnp.asarray(q0), a))(
        jnp.asarray(scales), jnp.asarray(alpha0))
    _assert_step(got, want)
    assert len(set(got.alpha.tolist())) > 2
    assert bool(torch.all(got.loss_after_kw <= got.loss_before_kw))
    for i in range(len(scales)):  # each lane is the unbatched step
        one = step(scales[i] * s_reactive, q0, alpha0[i])
        for k in vvc.VVCStep._fields:
            assert torch.equal(getattr(one, k), getattr(got, k)[i]), k


def test_run_rounds_match_reference(feeders, s_reactive):
    f, rf = feeders
    step = vvc.make_vvc_controller(f, device="cpu")
    ref_step = ref_vvc.make_vvc_controller(rf)
    q0 = np.zeros((f.n_branches, 3))
    got = vvc.run_rounds(step, s_reactive, q0, PARITY_ROUNDS)
    want = ref_vvc.run_rounds(ref_step, s_reactive, jnp.asarray(q0),
                              PARITY_ROUNDS)
    for a, b, k in zip(got, want, ("q", "losses", "alphas", "improved")):
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(b, np.float64), rtol=0,
                                   atol=ATOL, err_msg=k)
    assert got[1].shape == (PARITY_ROUNDS,)


def test_rounds_follow_reference_trajectory(feeders, s_reactive):
    f, rf = feeders
    step = vvc.make_vvc_controller(f, device="cpu")
    ref_step = ref_vvc.make_vvc_controller(rf)
    q, alpha = np.zeros((f.n_branches, 3)), 2000.0
    for _ in range(120):
        want = ref_step(s_reactive, jnp.asarray(q), alpha)
        _assert_step(step(s_reactive, q, alpha), want)
        q = np.asarray(want.q_ctrl_kvar)
        alpha = max(float(want.alpha) * 2.0 if bool(want.improved)
                    else alpha * 0.5, 1e-3)


def test_run_rounds_converge_to_optimum(feeders, s_reactive):
    f, _ = feeders
    step = vvc.make_vvc_controller(f, device="cpu")
    q0 = np.zeros((f.n_branches, 3))
    qf, losses, alphas, improved = vvc.run_rounds(step, s_reactive, q0, 120)
    losses = losses.numpy()
    assert np.all(np.diff(losses) <= 1e-12)
    base = step(s_reactive, q0)
    assert losses[-1] < 0.92 * float(base.loss_before_kw)
    assert abs(losses[-1] - losses[-10]) < 1e-5
    assert float(step(s_reactive, qf).loss_after_kw) >= losses[-1] - 1e-6


def test_q_limits_and_dead_phases_hold_over_rounds(feeders, s_reactive):
    f, _ = feeders
    cfg = vvc.VVCConfig(q_min_kvar=-5.0, q_max_kvar=5.0)
    step = vvc.make_vvc_controller(f, config=cfg, device="cpu")
    qf, _, _, _ = vvc.run_rounds(step, s_reactive, np.zeros((8, 3)), 30)
    assert float(qf.max()) <= 5.0 + 1e-12 and float(qf.min()) >= -5.0 - 1e-12
    mask = torch.tensor(f.phase_mask, dtype=F64)
    assert float((qf * (1 - mask)).abs().max()) == 0.0


def test_gradient_matches_central_difference(feeders, s_reactive):
    f, _ = feeders
    out = vvc.make_vvc_controller(f, device="cpu")(s_reactive,
                                                   np.zeros((8, 3)))
    _, fixed = ladder.make_ladder_solver(f, device="cpu")
    mask = torch.tensor(f.phase_mask, dtype=F64)
    p = torch.tensor(s_reactive.real)
    qs = torch.tensor(s_reactive.imag)

    def loss(q):
        return float(ladder.total_loss_kw(f, fixed((p, qs - q * mask))))

    eps = 1e-4
    dq = torch.zeros(8, 3, dtype=F64)
    dq[3, 0] = eps
    fd = (loss(dq) - loss(-dq)) / (2 * eps)
    assert fd == pytest.approx(float(out.grad_kw_per_kvar[3, 0]), rel=1e-4,
                               abs=1e-10)


# ---------------------------------------------------------------------------
# The vvc workload
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def services():
    cfg = dict(max_batch=4, max_wait_ms=25.0, queue_depth=64,
               buckets=BUCKETS, cache_mb=0.0)
    ref = RefService(RefServeConfig(**cfg))
    port = Service(ServeConfig(device="cpu", **cfg))
    yield ref, port
    port.stop()
    ref.stop()


def _proposals(nb):
    rng = np.random.default_rng(9)
    return {"zero": np.zeros((nb, 3)),
            "random": rng.uniform(-50.0, 50.0, (nb, 3)),
            "full": np.full((nb, 3), 100.0),
            "heavy": np.full((nb, 3), -400.0)}


@pytest.mark.parametrize("name", ["zero", "random", "full", "heavy"])
def test_vvc_what_if_matches_reference(services, name):
    ref, svc = services
    nb = svc.engine("vvc", "vvc_9bus").nb
    q = _proposals(nb)[name]
    got = svc.request("vvc", {"case": "vvc_9bus", "q_ctrl_kvar": q.tolist()})
    want = ref.request("vvc", {"case": "vvc_9bus",
                               "q_ctrl_kvar": q.tolist()})
    assert got.workload == "vvc" and got.case == "vvc_9bus"
    assert got.converged == want.converged
    assert got.converged == (name != "heavy")  # heavy: the ladder diverges
    assert got.band_violations == want.band_violations
    for k in ("loss_kw", "loss_base_kw", "loss_delta_kw", "v_min_pu",
              "v_max_pu", "residual"):
        assert abs(getattr(got, k) - getattr(want, k)) <= ATOL, k
    if name == "zero":
        assert abs(got.loss_delta_kw) < 1e-6  # the baseline itself
    if name == "full":
        assert abs(got.loss_kw - svc.request(
            "vvc", {"case": "vvc_9bus",
                    "q_ctrl_kvar": np.zeros((nb, 3)).tolist()}
        ).loss_kw) > 1e-4
    d = got.to_dict()
    assert set(d["batch"]) == {"lanes", "bucket", "queue_ms", "solve_ms",
                               "tier"}


def test_vvc_validation_errors_are_typed(services):
    ref, svc = services
    eng = svc.engine("vvc", "vvc_9bus")
    nb = eng.nb
    cases_ = [
        ({"case": "vvc_9bus", "q_ctrl_kvar": [[0.0] * 3]}, "must be"),
        ({"case": "vvc_9bus",
          "q_ctrl_kvar": np.full((nb, 3), np.nan).tolist()}, "non-finite"),
        ({"case": "ieee13", "q_ctrl_kvar": []}, "unknown feeder case"),
        ({"case": "vvc_9bus", "q_ctrl_kvar": "x"}, "malformed request field"),
        ({"case": "vvc_9bus", "q": []}, "unknown field"),
    ]
    for body, match in cases_:
        with pytest.raises(InvalidRequest, match=match) as got:
            svc.request("vvc", dict(body))
        if match in ("must be", "non-finite", "unknown feeder case"):
            with pytest.raises(Exception) as want:
                ref.request("vvc", dict(body))
            assert str(got.value) == str(want.value)
    assert FEEDER_CASES == ("vvc_9bus",) and V_BAND == (0.95, 1.05)
    # A proposal on a dead phase (vvc_9bus has none: mask one out).
    dead = eng._mask.copy()
    dead[2, 1] = 0.0
    saved, eng._mask = eng._mask, dead
    try:
        with pytest.raises(InvalidRequest, match="dead node-phase"):
            eng.validate(VVCRequest(case="vvc_9bus",
                                    q_ctrl_kvar=np.ones((nb, 3))))
    finally:
        eng._mask = saved


def test_vvc_ok_counter_counts_each_answer(services):
    _, svc = services
    nb = svc.engine("vvc", "vvc_9bus").nb
    # An earlier test's answer may be counted after its future resolved:
    # read the counter once the batcher owes no completion.
    deadline = time.monotonic() + 10
    while svc.batcher.busy() and time.monotonic() < deadline:
        time.sleep(0.005)
    ok = obs.SERVE_REQUESTS.labels("vvc", "ok").value
    svc.request("vvc", VVCRequest(case="vvc_9bus",
                                  q_ctrl_kvar=np.zeros((nb, 3))))
    # The future resolves inside scatter, before the batcher counts the
    # completion: wait (bounded) for the count instead of racing it.
    deadline = time.monotonic() + 10
    while (obs.SERVE_REQUESTS.labels("vvc", "ok").value < ok + 1
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert obs.SERVE_REQUESTS.labels("vvc", "ok").value == ok + 1


def test_concurrent_vvc_requests_each_get_their_own_answer(services):
    ref, svc = services
    nb = svc.engine("vvc", "vvc_9bus").nb
    rng = np.random.default_rng(21)
    qs = [rng.uniform(-50.0, 50.0, (nb, 3)) for _ in range(8)]
    out = [None] * len(qs)
    barrier = threading.Barrier(len(qs))

    def worker(i):
        barrier.wait(timeout=60)
        out[i] = svc.request("vvc", {"case": "vvc_9bus",
                                     "q_ctrl_kvar": qs[i].tolist()})

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(qs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert max(r.batch.lanes for r in out) > 1  # coalesced into batches
    for q, r in zip(qs, out):
        want = ref.request("vvc", {"case": "vvc_9bus",
                                   "q_ctrl_kvar": q.tolist()})
        assert abs(r.loss_kw - want.loss_kw) <= ATOL
        assert r.batch.bucket in BUCKETS and r.batch.bucket >= r.batch.lanes


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def test_vvc_http_route(services):
    ref, svc = services
    nb = svc.engine("vvc", "vvc_9bus").nb
    server = ServeServer(svc).start()
    try:
        q = _proposals(nb)["random"].tolist()
        status, body = _post(server.port, "/v1/vvc",
                             json.dumps({"case": "vvc_9bus",
                                         "q_ctrl_kvar": q}))
        assert status == 200
        want = ref.request("vvc", {"case": "vvc_9bus", "q_ctrl_kvar": q})
        assert abs(body["loss_kw"] - want.loss_kw) <= ATOL
        assert body["band_violations"] == want.band_violations
        status, body = _post(server.port, "/v1/vvc",
                             json.dumps({"case": "vvc_9bus",
                                         "q_ctrl_kvar": [[1.0]]}))
        assert status == 400 and body["error"]["type"] == "invalid_request"
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert "vvc" in health["workloads"]
        assert health["feeder_cases"] == ["vvc_9bus"]
    finally:
        server.stop()


def test_vvc_prewarm_runs_every_bucket():
    svc = Service(ServeConfig(max_batch=2, buckets=(1, 2), device="cpu",
                              cache_mb=0.0, prewarm=("vvc/vvc_9bus",)))
    try:
        st = svc.stats()
        assert st["prewarmed"] == ["vvc/vvc_9bus:1", "vvc/vvc_9bus:2"]
        assert "vvc" in st["executor_lanes"]
        assert svc.config.vvc_pf_iters == 20
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_vvc_step_on_card_matches_plain(cuda_device, feeders, s_reactive):
    from freedm_tpu_torch.kernels import ladder_kernels as lk

    f, _ = feeders
    scales = np.linspace(0.5, 1.2, 4)[:, None, None]
    loads = scales * s_reactive[None]
    q0 = np.zeros((f.n_branches, 3))
    lk.reset_launches()
    got = vvc.make_vvc_controller(f, device=cuda_device)(loads, q0)
    torch.cuda.synchronize()
    assert lk.launches()["ladder_vjp"] == 1
    want = vvc.make_vvc_controller(f, device=cuda_device, plain=True)(
        loads, q0)
    for k in vvc.VVCStep._fields:
        a, b = getattr(got, k).cpu(), getattr(want, k).cpu()
        if a.dtype == torch.bool:
            assert torch.equal(a, b), k
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=ATOL, err_msg=k)
