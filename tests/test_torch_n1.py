"""N-1 screening of the PyTorch port against the JAX package.

``freedm_tpu_torch`` against ``freedm_tpu`` (CPU, x64) on the same seeded
numpy inputs, float64:

- the branch-wise injections with a per-lane branch status (``[m]`` and
  ``[B, m]``) against ``make_injection_fn(..., status)``: 1e-12 (the same
  operations; sin and cos from two libraries);
- S1's plain version with status: P and Q against the reference's
  ``s_calc`` on its ``ybus_dense(sys, status)``, the mismatch against the
  dense port's K1 on the status Ybus, the values (through S2) against K1's
  Jacobian, 1e-12; an all-in-service status gives the no-status bits;
- the sparse solver with status against the reference's vmapped
  ``make_sparse_newton_solver(...)(status=...)``, the reference's bf16
  preconditioner carried into the port: f64 at ``tol=1e-10`` within
  1e-9 pu with equal iterations (``tests/test_torch_sparse.py`` says why
  1e-10); mixed within 2e-4 pu, iterations ±1, equal flags and fallbacks;
- ``secure_outages`` equal to the reference's list;
- ``make_n1_screen`` (SMW and sparse) against the reference's: v and θ
  within 1e-9 pu, equal ``converged`` and ``iterations``.  The sparse
  screens both run on the float64 LU FDLF pair (``kind="lu"``; the
  reference's through its module's ``build_fdlf_precond``, patched in
  the test): on the default bf16 inverse pair the inexact inner solve
  moves a warm-started lane's mismatch after a step by tens of percent
  between two libraries' roundings, and with 38 lanes (case_ieee30) some
  lane's step starts within a factor 1.2-1.4 of any tolerance tried
  (1e-8 to 1e-10), so a lane can stop one step apart; N1's modes
  against the reference's screen iteration by iteration (max_iter = 0,
  1, 2) on the pinned-endpoint outages of case_ieee30, 1e-12;
- the ``n1`` service contracts of ``tests/test_serve.py`` on
  ``device="cpu"``.

The ``cuda``-marked tests hold S1 with status and N1 to their plain
versions on the card (``chip_smoke.py`` does so at full size).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.grid.bus import ybus_dense as ref_ybus_dense
from freedm_tpu.pf.krylov import build_fdlf_precond as ref_build_precond
from freedm_tpu.pf.mfree import make_injection_fn as ref_make_injection_fn
from freedm_tpu.pf.n1 import make_n1_screen as ref_make_n1_screen
from freedm_tpu.pf.n1 import secure_outages as ref_secure_outages
from freedm_tpu.pf.newton import s_calc as ref_s_calc
from freedm_tpu.pf import sparse as ref_sparse
from freedm_tpu.pf.sparse import make_sparse_newton_solver as ref_make_sparse
from freedm_tpu.serve.service import ServeConfig as RefServeConfig
from freedm_tpu.serve.service import Service as RefService
from freedm_tpu_torch.core import metrics as obs
from freedm_tpu_torch.grid.bus import BusSystem, ybus_dense
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import screen_kernels as sck
from freedm_tpu_torch.kernels import sparse_kernels as sk
from freedm_tpu_torch.pf import sparse
from freedm_tpu_torch.pf.fdlf import make_fdlf_solver
from freedm_tpu_torch.pf.krylov import FdlfPrecond, build_fdlf_precond
from freedm_tpu_torch.pf.mfree import make_injection_fn
from freedm_tpu_torch.pf.n1 import (make_n1_screen, secure_outages,
                                    smw_operands)
from freedm_tpu_torch.pf.newton import make_newton_solver
from freedm_tpu_torch.serve.queue import InvalidRequest
from freedm_tpu_torch.serve.service import N1Request, ServeConfig, Service

F64 = torch.float64
LANES = 3
SOLVE_TOL = 1e-10  # the sparse solves' tolerance (module docstring)
MIXED_DV_BOUND = 2e-4
#: Chord outages of mesh118 (branches past the ring never island it).
CHORDS = list(range(118, 130))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU path is thousands of tiny ops: one torch thread (see
    ``tests/test_torch_sparse.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_pair(ref):
    """The reference's bf16 FDLF pair, and the same pair in the port."""
    pair = ref_build_precond(ref, dtype=jnp.float64)
    return pair, FdlfPrecond.from_arrays(np.asarray(pair.bp, np.float32),
                                         np.asarray(pair.bq, np.float32),
                                         device="cpu")


def _ref_system(name):
    if name.startswith("mesh"):
        return ref_cases.synthetic_mesh(int(name[4:]), seed=1, load_mw=10.0,
                                        chord_frac=1.0)
    return ref_matpower.load_builtin(name)


_SYSTEMS = {}


def _systems(name):
    if name not in _SYSTEMS:
        ref = _ref_system(name)
        _SYSTEMS[name] = (ref, BusSystem.from_arrays(dataclasses.asdict(ref)))
    return _SYSTEMS[name]


def _status(m, lanes, seed):
    """0/1 status rows: about one branch in five out."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(lanes, m)) > 0.2).astype(np.float64)


def _random_state(n, lanes, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.2, 0.2, (lanes, n)),
                           rng.uniform(0.95, 1.05, (lanes, n))], axis=1)


# ---------------------------------------------------------------------------
# Injections and S1 with a per-lane status
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("name", ["case14", "mesh118"])
def test_injection_with_status_matches_reference(name, rows):
    ref, sys = _systems(name)
    n, m = sys.n_bus, sys.n_branch
    rng = np.random.default_rng(5 + n)
    theta = rng.uniform(-0.3, 0.3, (LANES, n))
    v = rng.uniform(0.9, 1.1, (LANES, n))
    status = _status(m, LANES, seed=n) if rows else _status(m, 1, seed=n)[0]
    inject = make_injection_fn(sys, device="cpu")
    p, q = inject(torch.as_tensor(theta), torch.as_tensor(v), status=status)
    ref_inject = ref_make_injection_fn(ref, jnp.float64)
    for b in range(LANES):
        st = status[b] if rows else status
        rp, rq = ref_inject(jnp.asarray(theta[b]), jnp.asarray(v[b]),
                            status=jnp.asarray(st))
        np.testing.assert_allclose(p[b].numpy(), np.asarray(rp), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(q[b].numpy(), np.asarray(rq), rtol=0,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="status"):
        inject(torch.as_tensor(theta), torch.as_tensor(v),
               status=np.ones(m + 1))


def _assemble_case(name):
    ref, sys = _systems(name)
    n, m = sys.n_bus, sys.n_branch
    x = torch.as_tensor(_random_state(n, LANES, seed=11 + n))
    rng = np.random.default_rng(12 + n)
    ps = torch.as_tensor(rng.normal(size=(LANES, n)))
    qs = torch.as_tensor(rng.normal(size=(LANES, n)))
    st = torch.as_tensor(_status(m, LANES, seed=13 + n))
    return ref, sys, sparse.sparse_operands(sys, device="cpu"), x, ps, qs, st


def _k1_status(sys, op, x, ps, qs, st):
    """The dense port's K1 plain version lane by lane on each lane's own
    status Ybus: ``(J [B, 2n, 2n], f [B, 2n])``."""
    jacs, fs = [], []
    for b in range(x.shape[0]):
        y_re, y_im = ybus_dense(sys, status=st[b].numpy(), device="cpu")
        j, f = nk.newton_assemble_plain(x[b:b + 1], y_re, y_im, ps[b:b + 1],
                                        qs[b:b + 1], op.th_free, op.v_free,
                                        op.v_set)
        jacs.append(j)
        fs.append(f)
    return torch.cat(jacs), torch.cat(fs)


@pytest.mark.parametrize("mode", [sk.FULL, sk.VALUES_F32, sk.RESIDUAL])
@pytest.mark.parametrize("name", ["case14", "mesh118"])
def test_assemble_plain_with_status_matches_reference(name, mode):
    """P and Q against the reference's ``s_calc`` on its status Ybus (the
    values of its ``_assemble(θ, V, status)``), f against K1 on the port's
    status Ybus, 1e-12 (float32 values within one float32 rounding)."""
    ref, sys, op, x, ps, qs, st = _assemble_case(name)
    n = sys.n_bus
    out = sk.sparse_assemble(x, ps, qs, op, mode, st)
    p, q = (out[0], out[1]) if mode == sk.RESIDUAL else (out[1][:, 4],
                                                         out[1][:, 5])
    for b in range(LANES):
        y = ref_ybus_dense(ref, status=jnp.asarray(st[b].numpy()),
                           dtype=jnp.float64)
        want_p, want_q = ref_s_calc(y, jnp.asarray(x[b, :n].numpy()),
                                    jnp.asarray(x[b, n:].numpy()))
        for got, want in ((p[b], want_p), (q[b], want_q)):
            want = np.asarray(want)
            atol = (1e-12 if got.dtype == F64
                    else 1e-12 + 2 ** -24 * float(np.abs(want).max()))
            np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                       atol=atol)
    _, want_f = _k1_status(sys, op, x, ps, qs, st)
    np.testing.assert_allclose(out[2].numpy(), want_f.numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["case14", "mesh118"])
def test_assemble_status_values_match_dense_jacobian(name):
    """S1's values with status, through S2, against each lane's K1
    Jacobian on its status Ybus (1e-12 relative to |J·u|)."""
    _, sys, op, x, ps, qs, st = _assemble_case(name)
    ev, bv, _ = sk.sparse_assemble(x, ps, qs, op, sk.FULL, st)
    u = torch.as_tensor(np.random.default_rng(3).normal(
        size=(LANES, 2 * sys.n_bus)))
    got = sk.sparse_matvec(ev, bv, u, op)
    jac, _ = _k1_status(sys, op, x, ps, qs, st)
    want = (jac @ u[:, :, None])[:, :, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["case14", "mesh118"])
def test_all_in_service_status_gives_the_stored_diagonal_bits(name):
    """The per-lane diagonal sums the self terms in the order the host
    stamped the stored one: an all-ones status gives the no-status
    bits in every mode (float64)."""
    _, sys, op, x, ps, qs, _ = _assemble_case(name)
    ones = torch.ones(LANES, sys.n_branch, dtype=F64)
    for mode in (sk.FULL, sk.VALUES_F32, sk.RESIDUAL):
        a = sk.sparse_assemble(x, ps, qs, op, mode)
        b = sk.sparse_assemble(x, ps, qs, op, mode, ones)
        assert all(chip_smoke.same_bits(torch, u, w) for u, w in zip(a, b))


# ---------------------------------------------------------------------------
# The sparse solver with status
# ---------------------------------------------------------------------------


def _solver_status(m):
    """Single chord outages, a double outage and an all-in-service lane."""
    st = np.ones((5, m))
    for i, k in enumerate(CHORDS[:3]):
        st[i, k] = 0.0
    st[3, [CHORDS[4], CHORDS[7]]] = 0.0
    return st


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_sparse_solver_with_status_matches_reference(precision):
    ref, sys = _systems("mesh118")
    pair, port_pair = _ref_pair(ref)
    st = _solver_status(sys.n_branch)
    solve, _ = ref_make_sparse(ref, precond=pair, precision=precision,
                               tol=SOLVE_TOL)
    want = jax.vmap(lambda s: solve(status=s))(jnp.asarray(st))
    psolve, _ = sparse.make_sparse_newton_solver(
        sys, precond=port_pair, precision=precision, tol=SOLVE_TOL,
        device="cpu")
    got = psolve(status=st)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert bool(got.converged.all())
    np.testing.assert_array_equal(got.fallbacks.numpy(),
                                  np.asarray(want.fallbacks))
    its, want_its = got.iterations.numpy(), np.asarray(want.iterations)
    if precision == "f64":
        np.testing.assert_array_equal(its, want_its)
        atol = 1e-9
    else:
        assert np.all(np.abs(its - want_its) <= 1)
        atol = MIXED_DV_BOUND
    for k in ("v", "theta"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=atol, err_msg=k)
    # A [m] status runs every lane on the same topology.
    one = psolve(status=st[0], p_inj=np.stack([sys.p_inj] * 2))
    np.testing.assert_allclose(one.v.numpy()[1], got.v.numpy()[0], rtol=0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# The screens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["case14", "case_ieee30", "mesh118"])
def test_secure_outages_match_reference(name):
    ref, sys = _systems(name)
    assert secure_outages(sys) == ref_secure_outages(ref)


def _outages(name):
    if name == "mesh118":
        return CHORDS
    return secure_outages(_systems(name)[1])


@pytest.mark.parametrize("name,backend", [
    ("case_ieee30", "dense"), ("case_ieee30", "sparse"),
    ("mesh118", "dense"), ("mesh118", "sparse")])
def test_n1_screen_matches_reference(name, backend, monkeypatch):
    ref, sys = _systems(name)
    port_kw = {}
    if backend == "sparse":  # both on the float64 LU pair (docstring)
        ref_build = ref_sparse.build_fdlf_precond
        monkeypatch.setattr(ref_sparse, "build_fdlf_precond",
                            lambda s, **kw: ref_build(s, **{**kw,
                                                            "kind": "lu"}))
        port_kw["precond"] = build_fdlf_precond(sys, kind="lu",
                                                device="cpu")
    want = ref_make_n1_screen(ref, backend=backend, max_iter=24,
                              dtype=jnp.float64)(jnp.asarray(_outages(name)))
    got = make_n1_screen(sys, backend=backend, max_iter=24, device="cpu",
                         **port_kw)(_outages(name))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert bool(got.converged.all())
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.fallbacks.numpy(), 0)
    for k in ("v", "theta"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-9, err_msg=k)


def _pinned(sys):
    bt = np.asarray(sys.bus_type)
    return [k for k in secure_outages(sys)
            if bt[sys.from_bus[k]] != 0 or bt[sys.to_bus[k]] != 0]


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_smw_sweep_modes_match_reference_iteration_by_iteration(iters):
    """N1's plain version in every mode against the reference's screen
    body on the pinned-endpoint outages of case_ieee30 (update columns
    masked): ``max_iter = 0`` is INIT then FINISH, 1 and 2 add the THETA
    and V halves; θ, V, P, Q and the mismatch within 1e-12."""
    ref, sys = _systems("case_ieee30")
    ks = _pinned(sys)
    assert ks
    want = ref_make_n1_screen(ref, max_iter=iters, dtype=jnp.float64)(
        jnp.asarray(ks))
    got = make_n1_screen(sys, max_iter=iters, device="cpu")(ks)
    for k in ("v", "theta", "p", "q", "mismatch"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(got.iterations.numpy(), iters)


def test_smw_operands_hold_each_branch_block():
    """``cap`` is ``I₂ + ZM[idx]·mask`` per branch, ``ZM`` branch-major,
    and a pinned endpoint's update column is zero."""
    _, sys = _systems("case14")
    _, _, op = smw_operands(sys, device="cpu")
    m, n = sys.n_branch, sys.n_bus
    assert op.zm.shape == (2, m, n, 2) and op.cap.shape == (2, m, 2, 2)
    k = 0  # branch 0 leaves the slack bus: its B′ column there is masked
    assert op.mask[0, k, 0] == 0.0
    ends = [int(sys.from_bus[k]), int(sys.to_bus[k])]
    for h in (0, 1):
        want = torch.eye(2, dtype=F64) + op.zm[h, k][ends] * op.mask[h, k][:, None]
        assert torch.equal(op.cap[h, k], want)


def test_solve2_is_lapack_partial_pivoting():
    rng = np.random.default_rng(9)
    cap = torch.as_tensor(rng.normal(size=(64, 2, 2)))
    cap[:8, 1, 0] = 0.0  # no swap
    cap[8:16, 0, 0] = 1e-3  # swap
    b = torch.as_tensor(rng.normal(size=(64, 2)))
    want = np.linalg.solve(cap.numpy(), b.numpy()[:, :, None])[:, :, 0]
    np.testing.assert_allclose(sck.solve2_plain(cap, b).numpy(), want,
                               rtol=1e-10, atol=1e-12)


def test_screen_arguments_are_typed():
    _, sys = _systems("case14")
    with pytest.raises(NotImplementedError, match="mesh"):
        make_n1_screen(sys, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="precision"):
        make_n1_screen(sys, device="cpu", precision="f16")
    with pytest.raises(TypeError, match="float64"):
        make_n1_screen(sys, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="dc_prefilter"):
        make_n1_screen(sys, device="cpu", dc_prefilter=0)
    # The rest of item 8 is ported: the FDLF solver and status on the dense
    # backend take the same typed status check as the sparse one.
    fdlf, _ = make_fdlf_solver(sys, device="cpu")
    dense, _ = make_newton_solver(sys, device="cpu")
    for solve in (fdlf, dense):
        with pytest.raises(ValueError, match="status must be"):
            solve(status=np.ones((2, sys.n_branch - 1)))


# ---------------------------------------------------------------------------
# The n1 service (tests/test_serve.py's contracts, on the port)
# ---------------------------------------------------------------------------

BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module")
def services():
    cfg = dict(max_batch=4, max_wait_ms=25.0, queue_depth=64,
               buckets=BUCKETS, cache_mb=0.0)
    ref = RefService(RefServeConfig(**cfg))
    port = Service(ServeConfig(device="cpu", **cfg))
    yield ref, port
    port.stop()
    ref.stop()


def test_n1_validation_errors_are_typed(services):
    _, svc = services
    with pytest.raises(InvalidRequest):
        svc.request("n1", {"case": "case14", "outages": []})
    with pytest.raises(InvalidRequest, match="ints in"):
        svc.request("n1", {"case": "case14", "outages": [10**6]})
    eng = svc.engine("n1", "case14")
    islanding = sorted(set(range(eng.n_branch)) - set(eng._secure))
    assert islanding, "case14 has bridge branches"
    with pytest.raises(InvalidRequest) as ei:
        svc.request("n1", {"case": "case14", "outages": [islanding[0]]})
    assert "island" in str(ei.value)
    # Wider than the batch ceiling, and a wrong-typed value: typed 400s.
    with pytest.raises(InvalidRequest, match="max_batch"):
        svc.request("n1", {"case": "case14",
                           "outages": list(eng._secure)[:5]})
    with pytest.raises(InvalidRequest):
        svc.request("n1", {"case": "case14", "outages": 5})
    with pytest.raises(InvalidRequest, match="unknown field"):
        svc.request("n1", {"case": "case14", "outages": [1], "k": 1})


@pytest.mark.parametrize("case", ["case14", "case_ieee30"])
def test_n1_roundtrip_matches_reference(services, case):
    """The SMW screen through the service: the requested subset, each
    lane's voltage extremes within 1e-9 pu of the reference service's,
    the same flags."""
    ref, svc = services
    eng = svc.engine("n1", case)
    assert eng.pf_backend == "dense" and eng.pf_precision == "f64"
    ks = list(eng._secure)[:3]
    ok = obs.SERVE_REQUESTS.labels("n1", "ok").value
    r = svc.request("n1", {"case": case, "outages": ks})
    # The future resolves inside scatter, before the batcher counts the
    # completion: wait (bounded) for the count instead of racing it.
    deadline = time.monotonic() + 10
    while (obs.SERVE_REQUESTS.labels("n1", "ok").value < ok + 1
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert obs.SERVE_REQUESTS.labels("n1", "ok").value == ok + 1
    want = ref.request("n1", {"case": case, "outages": ks})
    assert r.outages == ks == want.outages
    assert r.converged == want.converged and r.all_converged
    assert r.worst_residual_pu < 1e-6
    assert max(r.residual_pu) == r.worst_residual_pu
    assert r.batch.bucket >= 3 and r.batch.lanes == 3
    for k in ("v_min_pu", "v_max_pu", "residual_pu"):
        np.testing.assert_allclose(getattr(r, k), getattr(want, k), rtol=0,
                                   atol=1e-9, err_msg=k)


def test_n1_stats_attribute_recompiles_per_bucket(services):
    _, svc = services
    eng = svc.engine("n1", "case_ieee30")
    ks = list(eng._secure)
    svc.request("n1", N1Request(case="case_ieee30", outages=ks[5:6]))
    svc.request("n1", N1Request(case="case_ieee30", outages=ks[6:9]))
    svc.request("n1", N1Request(case="case_ieee30", outages=ks[9:10]))
    table = svc.stats()["recompiles_by_bucket"]
    assert table["n1/case_ieee30:1"] == 1
    assert table["n1/case_ieee30:4"] == 1
    assert all(v == 1 for v in table.values())
    assert svc.stats()["recompiles"].get("n1", 0) >= sum(
        v for k, v in table.items() if k.startswith("n1/"))


def test_n1_sparse_service_matches_the_direct_screen():
    """mesh118 with ``pf_backend="sparse"`` takes the sparse screen; the
    served lanes equal the direct screen's (which the tests above hold to
    the reference); prewarm runs every bucket."""
    svc = Service(ServeConfig(device="cpu", max_batch=4, buckets=BUCKETS,
                              cache_mb=0.0, pf_backend="sparse",
                              prewarm=("n1/mesh118",)))
    try:
        eng = svc.engine("n1", "mesh118")
        assert eng.pf_backend == "sparse" and eng.pf_precision == "f64"
        assert sorted(svc.batcher.prewarmed) == [
            f"n1/mesh118:{b}" for b in BUCKETS]
        ks = CHORDS[:4]
        r = svc.request("n1", {"case": "mesh118", "outages": ks})
        _, sys = _systems("mesh118")
        direct = make_n1_screen(sys, max_iter=24, backend="sparse",
                                device="cpu")(ks)
        assert r.all_converged
        np.testing.assert_allclose(r.v_min_pu, direct.v.min(1).values,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(r.v_max_pu, direct.v.max(1).values,
                                   rtol=0, atol=1e-12)
        assert r.converged == direct.converged.tolist()
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# On the card: S1 with status and N1 against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_assemble_with_status_kernel_matches_plain_on_card(cuda_device):
    _, sys, _, x, ps, qs, st = _assemble_case("mesh118")
    op = sparse.sparse_operands(sys, device=cuda_device)
    x, ps, qs, st = (t.to(cuda_device) for t in (x, ps, qs, st))
    for mode in (sk.FULL, sk.VALUES_F32, sk.RESIDUAL):
        got = sk.sparse_assemble(x, ps, qs, op, mode, st)
        again = sk.sparse_assemble(x, ps, qs, op, mode, st)
        want = sk.sparse_assemble_plain(x, ps, qs, op, mode, st)
        for g, a, w in zip(got, again, want):
            assert chip_smoke.same_bits(torch, g, a)
            tol = 1e-12 if g.dtype == F64 else 1e-5
            torch.testing.assert_close(g.double(), w.double(), rtol=0,
                                       atol=tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_smw_sweep_kernel_matches_plain_on_card(cuda_device):
    _, sys = _systems("case_ieee30")
    ks = secure_outages(sys)
    got = make_n1_screen(sys, max_iter=24, device=cuda_device)(ks)
    want = make_n1_screen(sys, max_iter=24, device=cuda_device,
                          plain=True)(ks)
    for k in ("v", "theta", "p", "q", "mismatch"):
        torch.testing.assert_close(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-12)
    assert torch.equal(got.converged, want.converged)
    torch.cuda.synchronize()
