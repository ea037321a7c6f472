"""Parity of the PyTorch port's sparse Newton backend with the JAX package.

``freedm_tpu_torch.pf.sparse`` against ``freedm_tpu.pf.sparse`` (vmapped,
CPU, x64) on the same inputs, with the reference's bf16 FDLF pair carried
into the port (``FdlfPrecond.from_arrays``) so both solve with the same
M⁻¹.  On the CPU the kernel wrappers run their plain versions; the
``cuda``-marked test holds S1-S4 against those on the card.

Tolerances: S1/S2 1e-12 (sums in another order); float64 solves: flags
and iteration counts identical, v/θ within 1e-9 pu, p/q within 1e-8;
mixed: flags and fallbacks identical, iterations within ±1, 2e-4 pu
(``MIXED_DV_BOUND``, tests/test_precision.py); sparse vs dense 1e-6 pu
(``ATOL_V``, tests/test_sparse.py).

Why the float64 solves run at ``tol=1e-10``: the preconditioner rounds
its input and output to bf16, so a one-ulp difference anywhere upstream
(XLA's and torch's sin/cos, GEMM blocking) flips a few bf16 roundings and
moves the inexact inner solve's result by ~1e-12 relative.  A lane whose
mismatch after some step lands within a factor of a few of ``tol`` can
then stop one step earlier in one package than in the other.  At 1e-8
the mesh118 lanes' third-step mismatch sits at 4e-9..1e-8; at 1e-10 every
lane has a margin of more than 30x on both sides of the test.
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid.bus import ybus_dense as ref_ybus_dense
from freedm_tpu.pf.krylov import build_fdlf_precond as ref_build_precond
from freedm_tpu.pf.newton import s_calc as ref_s_calc
from freedm_tpu.pf.sparse import jacobian_pattern as ref_jacobian_pattern
from freedm_tpu.pf.sparse import make_sparse_newton_solver as ref_make_sparse
from freedm_tpu.serve.service import ServeConfig as RefServeConfig
from freedm_tpu.serve.service import Service as RefService
from freedm_tpu_torch.grid import cases
from freedm_tpu_torch.grid.bus import BusSystem, ybus_dense
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import sparse_kernels as sk
from freedm_tpu_torch.pf import sparse
from freedm_tpu_torch.pf.krylov import FdlfPrecond
from freedm_tpu_torch.pf.newton import make_newton_solver
from freedm_tpu_torch.serve.http import ServeServer
from freedm_tpu_torch.serve.service import ServeConfig, Service

F64 = torch.float64
TOL = 1e-10  # see the module docstring
MIXED_DV_BOUND = 2e-4
ATOL_V = 1e-6
#: Eight lanes at load scales 0.5-1.5, one past the nose point, and one
#: warm-started at its own solution (appended by the fixture).
SCALES = np.concatenate([np.linspace(0.5, 1.5, 8), [8.0, 1.0]])
DIVERGING, WARM = 8, 9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is thousands of tiny ops; on a shared host a
    multi-threaded pool spends far longer waking its threads than
    computing, so these tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(ref_sys):
    return BusSystem.from_arrays(dataclasses.asdict(ref_sys))


@pytest.fixture(scope="module")
def mesh118():
    ref = ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0, chord_frac=1.0)
    pair = ref_build_precond(ref, dtype=jnp.float64)
    port_pair = FdlfPrecond.from_arrays(np.asarray(pair.bp, np.float32),
                                        np.asarray(pair.bq, np.float32),
                                        device="cpu")
    return ref, _port(ref), pair, port_pair


@pytest.fixture(scope="module")
def lanes(mesh118):
    """Per-lane (p, q, v0, θ0): flat starts, and the warm lane started
    from the reference's float64 solution at its scale."""
    ref, _, pair, _ = mesh118
    n = ref.n_bus
    p = SCALES[:, None] * ref.p_inj
    q = SCALES[:, None] * ref.q_inj
    v0 = np.tile(np.where(ref.bus_type == 0, 1.0, ref.v_set), (len(SCALES), 1))
    th0 = np.zeros((len(SCALES), n))
    solve, _ = ref_make_sparse(ref, precond=pair, precision="f64", tol=TOL)
    base = solve(p_inj=p[WARM], q_inj=q[WARM])
    v0[WARM], th0[WARM] = np.asarray(base.v), np.asarray(base.theta)
    return p, q, v0, th0


def _ref_solve(mesh118, lanes, precision):
    ref, _, pair, _ = mesh118
    solve, _ = ref_make_sparse(ref, precond=pair, precision=precision,
                               tol=TOL)
    return jax.vmap(lambda a, b, c, d: solve(p_inj=a, q_inj=b, v0=c,
                                             theta0=d))(*lanes)


def _port_solve(mesh118, lanes, precision, **kw):
    _, sys, _, port_pair = mesh118
    solve, _ = sparse.make_sparse_newton_solver(
        sys, precond=port_pair, precision=precision, tol=TOL, device="cpu",
        **kw)
    p, q, v0, th0 = lanes
    return solve(p_inj=p, q_inj=q, v0=v0, theta0=th0)


@pytest.fixture(scope="module")
def f64_results(mesh118, lanes):
    return _ref_solve(mesh118, lanes, "f64"), _port_solve(mesh118, lanes, "f64")


def _np(a):
    return np.asarray(a)


def test_pattern_nnz_and_incidence(mesh118):
    ref, sys, _, _ = mesh118
    pat = sparse.jacobian_pattern(sys)
    assert pat.nnz == ref_jacobian_pattern(ref).nnz and pat.blocks == 4
    assert pat.nnz < 0.1 * (2 * sys.n_bus) ** 2
    # Every edge appears once at each end; per bus the from-end edges come
    # first, then the to-end edges, each ascending.
    assert pat.inc_ptr[-1] == 2 * sys.n_branch
    for i in range(sys.n_bus):
        codes = pat.inc_code[pat.inc_ptr[i]:pat.inc_ptr[i + 1]]
        side, edge = codes & 1, codes >> 1
        assert np.all(np.diff(side) >= 0)
        want = np.concatenate([np.flatnonzero(sys.from_bus == i),
                               np.flatnonzero(sys.to_bus == i)])
        np.testing.assert_array_equal(edge, want)
        ends = np.where(side == 0, sys.to_bus[edge], sys.from_bus[edge])
        np.testing.assert_array_equal(
            pat.inc_nbr[pat.inc_ptr[i]:pat.inc_ptr[i + 1]], ends)


def test_pattern_built_once_per_topology():
    sys_a = cases.synthetic_mesh(97, seed=101, load_mw=5.0, chord_frac=0.5)
    before = sparse.pattern_builds
    s1, _ = sparse.make_sparse_newton_solver(sys_a, max_iter=8, device="cpu")
    s2, _ = sparse.make_sparse_newton_solver(sys_a, max_iter=12,
                                             dtype=torch.float32,
                                             device="cpu")
    assert sparse.pattern_builds == before + 1
    sys_b = cases.synthetic_mesh(97, seed=102, load_mw=5.0, chord_frac=0.5)
    sparse.make_sparse_newton_solver(sys_b, max_iter=8, device="cpu")
    assert sparse.pattern_builds == before + 2
    r = s1(p_inj=np.stack([sys_a.p_inj, 1.1 * sys_a.p_inj]))
    s2()
    assert sparse.pattern_builds == before + 2
    assert bool(r.converged.all())


def _random_state(n, lanes, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.2, 0.2, (lanes, n)),
                           rng.uniform(0.95, 1.05, (lanes, n))], axis=1)


def test_assemble_plain_matches_reference_injections(mesh118):
    """S1's plain version: p/q against the reference's s_calc, and the
    masked mismatch against the dense port's K1 (held to the reference
    in tests/test_torch_newton.py)."""
    ref, sys, _, _ = mesh118
    n, b = ref.n_bus, 3
    x = _random_state(n, b, seed=21)
    ps = np.random.default_rng(22).normal(size=(b, n))
    qs = np.random.default_rng(23).normal(size=(b, n))
    op = sparse.sparse_operands(sys, device="cpu")
    ev, bv, f = sk.sparse_assemble(torch.as_tensor(x), torch.as_tensor(ps),
                                   torch.as_tensor(qs), op)
    assert ev.shape == (b, 4, 2 * ref.n_branch) and bv.shape == (b, 6, n)
    y = ref_ybus_dense(ref, dtype=jnp.float64)
    for lane in range(b):
        want_p, want_q = ref_s_calc(y, jnp.asarray(x[lane, :n]),
                                    jnp.asarray(x[lane, n:]))
        np.testing.assert_allclose(bv[lane, 4].numpy(), _np(want_p), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(bv[lane, 5].numpy(), _np(want_q), rtol=0,
                                   atol=1e-12)
    y_re, y_im = ybus_dense(sys, device="cpu")
    _, want_f = nk.newton_assemble_plain(
        torch.as_tensor(x), y_re, y_im, torch.as_tensor(ps),
        torch.as_tensor(qs), op.th_free, op.v_free, op.v_set)
    np.testing.assert_allclose(f.numpy(), want_f.numpy(), rtol=0, atol=1e-12)


def test_matvec_plain_matches_dense_jacobian(mesh118):
    """S2's plain version: J·u within 1e-12 (relative to |J·u|) of the
    dense port's K1 Jacobian times u, pinned rows included."""
    _, sys, _, _ = mesh118
    n, b = sys.n_bus, 3
    x = torch.as_tensor(_random_state(n, b, seed=31))
    ps = torch.as_tensor(np.random.default_rng(32).normal(size=(b, n)))
    op = sparse.sparse_operands(sys, device="cpu")
    ev, bv, _ = sk.sparse_assemble(x, ps, ps, op)
    u = torch.as_tensor(np.random.default_rng(33).normal(size=(b, 2 * n)))
    got = sk.sparse_matvec(ev, bv, u, op)
    y_re, y_im = ybus_dense(sys, device="cpu")
    jac, _ = nk.newton_assemble_plain(x, y_re, y_im, ps, ps, op.th_free,
                                      op.v_free, op.v_set)
    want = (jac @ u[:, :, None])[:, :, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


def test_f64_lanes_match_vmapped_reference(f64_results):
    want, got = f64_results
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  _np(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), _np(want.converged))
    conv = got.converged.numpy()
    assert conv.tolist() == [True] * 8 + [False, True]  # the nose-point lane
    assert got.iterations[WARM] == 1  # one step from its own solution
    for k, tol in (("v", 1e-9), ("theta", 1e-9), ("p", 1e-8), ("q", 1e-8)):
        np.testing.assert_allclose(getattr(got, k).numpy()[conv],
                                   _np(getattr(want, k))[conv], rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_array_equal(got.fallbacks.numpy(), 0)


def test_mixed_lanes_match_reference_and_f64(mesh118, lanes, f64_results):
    want = _ref_solve(mesh118, lanes, "mixed")
    got = _port_solve(mesh118, lanes, "mixed")
    f64 = f64_results[1]
    np.testing.assert_array_equal(got.converged.numpy(), _np(want.converged))
    np.testing.assert_array_equal(got.fallbacks.numpy(), _np(want.fallbacks))
    assert np.all(np.abs(got.iterations.numpy() - _np(want.iterations)) <= 1)
    assert got.iterations[WARM] == 0  # the warm start already meets tol
    assert got.fallbacks[DIVERGING] > 0  # the stalled lane fell through
    conv = got.converged.numpy()
    for k in ("v", "theta"):
        g = getattr(got, k).numpy()[conv]
        np.testing.assert_allclose(g, _np(getattr(want, k))[conv], rtol=0,
                                   atol=MIXED_DV_BOUND)
        np.testing.assert_allclose(g, getattr(f64, k).numpy()[conv], rtol=0,
                                   atol=MIXED_DV_BOUND)


def test_sparse_matches_dense_port(mesh118, lanes, f64_results):
    _, sys, _, _ = mesh118
    p, q, _, _ = lanes
    dense, _ = make_newton_solver(sys, max_iter=12, tol=TOL, device="cpu")
    rd = dense(p_inj=p[:8], q_inj=q[:8])
    rs = f64_results[1]
    np.testing.assert_array_equal(rs.converged.numpy()[:8],
                                  rd.converged.numpy())
    for k in ("v", "theta"):
        np.testing.assert_allclose(getattr(rs, k).numpy()[:8],
                                   getattr(rd, k).numpy(), rtol=0,
                                   atol=ATOL_V)


@pytest.mark.parametrize("precision,atol", [("f64", 1e-9),
                                            ("mixed", MIXED_DV_BOUND)])
def test_solve_fixed_matches_reference(mesh118, precision, atol):
    ref, sys, pair, port_pair = mesh118
    scales = np.array([0.8, 1.1])[:, None]
    p, q = scales * ref.p_inj, scales * ref.q_inj
    _, ref_fixed = ref_make_sparse(ref, max_iter=3, precond=pair,
                                   precision=precision)
    want = jax.vmap(lambda a, b: ref_fixed(p_inj=a, q_inj=b))(p, q)
    _, fixed = sparse.make_sparse_newton_solver(
        sys, max_iter=3, precond=port_pair, precision=precision,
        device="cpu")
    got = fixed(p_inj=p, q_inj=q)
    np.testing.assert_array_equal(got.iterations.numpy(), [3, 3])
    np.testing.assert_array_equal(got.fallbacks.numpy(), _np(want.fallbacks))
    np.testing.assert_allclose(got.v.numpy(), _np(want.v), rtol=0, atol=atol)
    np.testing.assert_allclose(got.theta.numpy(), _np(want.theta), rtol=0,
                               atol=atol)


def test_make_newton_solver_dispatches_and_keeps_caller_tensors(mesh118):
    _, sys, _, _ = mesh118
    solve, _ = make_newton_solver(sys, max_iter=12, backend="sparse",
                                  device="cpu")
    p = torch.as_tensor(np.stack([sys.p_inj, 1.2 * sys.p_inj]))
    v0 = torch.ones(2, sys.n_bus, dtype=F64)
    keep_p, keep_v = p.clone(), v0.clone()
    r = solve(p_inj=p, v0=v0)
    assert bool(r.converged.all()) and r.v.shape == (2, sys.n_bus)
    assert torch.equal(p, keep_p) and torch.equal(v0, keep_v)
    dense, _ = make_newton_solver(sys, max_iter=12, device="cpu")
    np.testing.assert_allclose(r.v.numpy(), dense(p_inj=p, v0=v0).v.numpy(),
                               rtol=0, atol=ATOL_V)


def test_solver_argument_errors_are_typed(mesh118):
    _, sys, _, port_pair = mesh118
    solve, _ = sparse.make_sparse_newton_solver(sys, precond=port_pair,
                                                device="cpu")
    with pytest.raises(ValueError, match="one row per lane"):
        solve(p_inj=np.zeros(sys.n_bus))
    with pytest.raises(ValueError, match="status"):
        solve(status=np.ones(sys.n_branch + 1))
    with pytest.raises(ValueError, match="lane counts"):
        solve(status=np.ones((2, sys.n_branch)), p_inj=np.zeros((3, sys.n_bus)))
    with pytest.raises(NotImplementedError, match="mesh"):
        sparse.make_sparse_newton_solver(sys, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="precision"):
        sparse.make_sparse_newton_solver(sys, device="cpu", precision="f16")
    with pytest.raises(TypeError, match="float64 or float32"):
        sparse.make_sparse_newton_solver(sys, device="cpu",
                                         dtype=torch.float16)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/pf", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_default_service_matches_reference_on_mesh600():
    """Default configs (``pf_backend="auto"``: sparse at 600 buses; f64
    inner solves on the CPU) answer the same mesh600 requests alike,
    each package building its own FDLF pair.  The scales are ones whose
    fourth-step mismatch sits more than 10x under the engine's 1e-8 in
    both packages (see the module docstring for why that margin)."""
    cfg = dict(max_batch=4, max_wait_ms=25.0, queue_depth=64, buckets=(1, 4))
    ref = RefService(RefServeConfig(cache_mb=0.0, **cfg))
    port = Service(ServeConfig(cache_mb=0.0, device="cpu", **cfg))
    server = ServeServer(port).start()
    try:
        reqs = [{"case": "mesh600", "scale": s} for s in (0.8, 0.9, 1.05)]
        futs = [port.submit("pf", dict(r)) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
        want_futs = [ref.submit("pf", dict(r)) for r in reqs]
        want = [f.result(timeout=120) for f in want_futs]
        status, body = _post(server.port, {"case": "mesh600", "scale": 1.2})
        assert status == 200
        got.append(port.request("pf", {"case": "mesh600", "scale": 1.2}))
        want.append(ref.request("pf", {"case": "mesh600", "scale": 1.2}))
        assert body["iterations"] == want[-1].iterations
        assert abs(body["p_balance_pu"] - want[-1].p_balance_pu) <= 1e-8
        eng = port.engine("pf", "mesh600")
        assert (eng.pf_backend, eng.pf_precision) == ("sparse", "f64")
        for g, w in zip(got, want):
            assert g.converged and w.converged
            assert g.iterations == w.iterations
            for k in ("p_balance_pu", "v_min_pu", "v_max_pu"):
                assert abs(getattr(g, k) - getattr(w, k)) <= 1e-8, k
    finally:
        server.stop()
        port.stop()
        ref.stop()


# ---------------------------------------------------------------------------
# On the card: S1-S4 against their plain versions (skipped on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sparse_kernels_match_plain_versions_on_card(cuda_device, mesh118):
    _, sys, _, _ = mesh118
    n, b = sys.n_bus, 3
    op = sparse.sparse_operands(sys, device=cuda_device)
    x = torch.as_tensor(_random_state(n, b, seed=41), device=cuda_device)
    ps = torch.as_tensor(np.random.default_rng(42).normal(size=(b, n)),
                         device=cuda_device)
    for kern, plain in zip(sk.sparse_assemble(x, ps, ps, op),
                           sk.sparse_assemble_plain(x, ps, ps, op)):
        torch.testing.assert_close(kern, plain, rtol=1e-12, atol=1e-12)
    ev, bv, f = sk.sparse_assemble_plain(x, ps, ps, op)
    u = torch.randn_like(x)
    torch.testing.assert_close(sk.sparse_matvec(ev, bv, u, op),
                               sk.sparse_matvec_plain(ev, bv, u, op),
                               rtol=1e-12, atol=1e-12)
    # S3/S4 through one GMRES cycle each way, Jacobi preconditioned.
    diag = torch.cat([bv[:, 0], bv[:, 3]], dim=1)
    free = torch.cat([op.th_free, op.v_free])
    diag = torch.where(free > 0, diag, torch.ones_like(diag))
    from freedm_tpu_torch.pf.krylov import _pgmres_block

    def cycle(plain):
        return _pgmres_block(lambda w: sk.sparse_matvec(ev, bv, w, op),
                             lambda w: w / diag, -f, m=16, s=4, plain=plain)

    torch.testing.assert_close(cycle(False), cycle(True), rtol=1e-9,
                               atol=1e-9 * float(cycle(True).abs().max()))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_operand_set_is_checked_once_and_its_pointers_kept(mesh118, dtype):
    """The wrappers check an operand set against the launch's dtype and
    device once and keep its device pointers for later launches."""
    _, sys, _, _ = mesh118
    op = sparse.sparse_operands(sys, dtype=dtype, device="cpu")
    like = torch.zeros(2, 2 * sys.n_bus, dtype=dtype)
    ptrs = sk._op_ptrs(op, like)
    assert ptrs == {name: t.data_ptr() for name, t in zip(op._fields, op)}
    assert sk._op_ptrs(op, like) is ptrs
    with pytest.raises(ValueError):  # the same set, another dtype
        sk._op_ptrs(op, like.to(torch.float32 if dtype == F64 else F64))


@pytest.mark.parametrize("bad", ["float dtype", "index dtype", "shape"])
def test_operand_check_refuses_a_mismatched_set(mesh118, bad):
    _, sys, _, _ = mesh118
    op = sparse.sparse_operands(sys, dtype=F64, device="cpu")
    if bad == "float dtype":
        op = op._replace(g_d=op.g_d.float())
    elif bad == "index dtype":
        op = op._replace(inc_code=op.inc_code.long())
    else:
        op = op._replace(inc_nbr=op.inc_nbr[:-1])
    with pytest.raises(ValueError):
        sk._op_ptrs(op, torch.zeros(2, 2 * sys.n_bus, dtype=F64))


@pytest.mark.cuda
def test_matvec_kernel_matches_plain_version_on_card(cuda_device, mesh118):
    """S2 against its plain version on mesh118 in both dtypes within
    chip_smoke.py's SPARSE_TOL, bit-identical on repeat."""
    from chip_smoke import SPARSE_TOL

    _, sys, _, _ = mesh118
    n, b = sys.n_bus, 3
    for dtype in (F64, torch.float32):
        tol = SPARSE_TOL[str(dtype)[6:]][0]
        op = sparse.sparse_operands(sys, dtype=dtype, device=cuda_device)
        x = torch.as_tensor(_random_state(n, b, seed=51),
                            device=cuda_device).to(dtype)
        ps = torch.as_tensor(np.random.default_rng(52).normal(size=(b, n)),
                             device=cuda_device).to(dtype)
        ev, bv, _ = sk.sparse_assemble_plain(x, ps, ps, op)
        u = torch.randn_like(x)
        got = sk.sparse_matvec(ev, bv, u, op)
        want = sk.sparse_matvec_plain(ev, bv, u, op)
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())
        assert torch.equal(got, sk.sparse_matvec(ev, bv, u, op))
    torch.cuda.synchronize()
