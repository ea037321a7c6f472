"""Parity of the port's reverse modes of the fixed solves with the JAX
package.

J2's plain version (``residual_vjp_plain``) is held to ``jax.vjp`` of the
reference's residual and injections (``freedm_tpu.pf.mfree.
make_injection_fn`` and the masks) at case14, case_ieee30 and mesh118 × 3
lanes in both modes, with and without status (float64, 1e-12 of the
largest entry), and to J1's plain version by ``⟨w, J u⟩ = ⟨Jᵀ w, u⟩``.
I2's plain version (``cim_vjp_plain``) is held to ``jax.vjp`` of the
reference's CIM iteration (``freedm_tpu/pf/cim.py:163`` ``_iterate``,
written here with the reference's ``cplx`` on its ``assemble_yabc``),
1e-12 of the largest entry.

Each autograd Function of ``freedm_tpu_torch.pf.adjoint`` runs its plain
route here (``adjoint=True`` on the CPU) and is held to ``jax.grad`` of
the reference's ``solve_fixed`` on the reference's gradient gates — dense
Newton ``synthetic_mesh(20, seed=10)``, 8 iterations, the total losses
(``tests/test_newton.py:162``); the krylov solver's
``synthetic_mesh(120, seed=4, load_mw=2.0, chord_frac=1.0)``, 6
iterations, inner 16, slack P (``tests/test_krylov.py:85``); the CIM on
vvc_9bus with ``TIE_5_8``, 80 iterations (``tests/test_cim.py:113``) —
and on FDLF at case_ieee30, 30 iterations, slack P.  Route B (one adjoint
solve at the last iterate) holds at rtol 1e-6 on these converged solves;
route A (the iterates walked back) at rtol 1e-9.  The unrolled CPU
gradients are held to the same references.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid.bus import PQ as REF_PQ
from freedm_tpu.grid.bus import SLACK as REF_SLACK
from freedm_tpu.grid.matpower import load_builtin as ref_load_builtin
from freedm_tpu.pf.cim import assemble_yabc as ref_assemble_yabc
from freedm_tpu.pf.cim import make_cim_solver as ref_make_cim
from freedm_tpu.pf.fdlf import make_fdlf_solver as ref_make_fdlf
from freedm_tpu.pf.krylov import make_krylov_solver as ref_make_krylov
from freedm_tpu.pf.mfree import make_injection_fn as ref_injection_fn
from freedm_tpu.pf.newton import branch_flows as ref_branch_flows
from freedm_tpu.pf.newton import make_newton_solver as ref_make_newton
from freedm_tpu.pf.sparse import make_sparse_newton_solver as ref_make_sparse
from freedm_tpu.utils import cplx as ref_cplx
from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.grid import cases
from freedm_tpu_torch.grid.bus import BusSystem
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf import adjoint as adj
from freedm_tpu_torch.pf.cim import assemble_yabc, make_cim_solver
from freedm_tpu_torch.pf.fdlf import make_fdlf_solver
from freedm_tpu_torch.pf.krylov import build_fdlf_precond, make_krylov_solver
from freedm_tpu_torch.pf.newton import branch_flows, make_newton_solver
from freedm_tpu_torch.pf.sparse import (make_sparse_newton_solver,
                                        sparse_operands)

F64 = torch.float64
ROUTE_B_RTOL = 1e-6
ROUTE_A_RTOL = 1e-9
TIE_5_8 = (5, 8, cases.Z_CODES_9BUS[0] / (1000.0 * 12.47**2 / 1000.0))
REF_TIE_5_8 = (5, 8, ref_cases.Z_CODES_9BUS[0] / (1000.0 * 12.47**2
                                                   / 1000.0))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Batched LU on the CPU runs on one thread (the MKL note in the
    verify skill); the CPU path is many small ops anyway."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(ref):
    return BusSystem.from_arrays(dataclasses.asdict(ref))


def _ref_case(name):
    if name.startswith("case"):
        return ref_load_builtin(name)
    return ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0,
                                    chord_frac=1.0)


def _grad(fn, *args):
    ts = [torch.as_tensor(a, dtype=F64).clone().requires_grad_(True)
          for a in args]
    return [g.numpy() for g in torch.autograd.grad(fn(*ts), ts)]


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape), want,
                               rtol=rtol, atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# J2's plain version
# ---------------------------------------------------------------------------


def _ref_functions(ref):
    """The reference's injections and masked residual of ``x = θ ‖ V``."""
    inj = ref_injection_fn(ref, jnp.float64)
    n = ref.n_bus
    th_free = jnp.asarray(ref.bus_type != REF_SLACK, jnp.float64)
    v_free = jnp.asarray(ref.bus_type == REF_PQ, jnp.float64)

    def full(x, status):
        p, q = inj(x[:n], x[n:], status=status)
        return jnp.concatenate([p, q])

    def masked(x, status):
        p, q = inj(x[:n], x[n:], status=status)
        return jnp.concatenate([
            jnp.where(th_free > 0, p - ref.p_inj, x[:n]),
            jnp.where(v_free > 0, q - ref.q_inj, x[n:] - ref.v_set)])

    return {sol.FULL: full, sol.MASKED: masked}


def _random_point(n, m, lanes, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 0.2, (lanes, n)),
                        rng.uniform(0.9, 1.1, (lanes, n))], 1)
    w = rng.normal(size=(lanes, 2 * n))
    st = (rng.random((lanes, m)) > 0.1).astype(np.float64)
    return x, w, st


@pytest.mark.parametrize("case", ["case14", "case_ieee30", "mesh118"])
@pytest.mark.parametrize("mode", [sol.MASKED, sol.FULL])
@pytest.mark.parametrize("with_status", [False, True])
def test_j2_plain_version_matches_reference_vjp(case, mode, with_status):
    ref = _ref_case(case)
    sys_ = _port(ref)
    n, m, lanes = sys_.n_bus, sys_.n_branch, 3
    x, w, st = _random_point(n, m, lanes, seed=12)
    fn = _ref_functions(ref)[mode]
    want = np.stack([np.asarray(jax.vjp(
        lambda z: fn(z, jnp.asarray(st[b]) if with_status else None),
        jnp.asarray(x[b]))[1](jnp.asarray(w[b]))[0]) for b in range(lanes)])
    op = sparse_operands(sys_, device="cpu")
    got = sol.residual_vjp(torch.as_tensor(x), torch.as_tensor(w), op,
                           sol.vjp_operands(op), mode,
                           torch.as_tensor(st) if with_status else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("with_status", [False, True])
def test_j2_is_the_transpose_of_j1(with_status):
    """``⟨w, J1 u⟩ = ⟨J2 w, u⟩`` lane by lane, mesh118 × 3."""
    sys_ = _port(_ref_case("mesh118"))
    n, m = sys_.n_bus, sys_.n_branch
    x, w, st = _random_point(n, m, 3, seed=3)
    u = np.random.default_rng(4).normal(size=x.shape)
    op = sparse_operands(sys_, device="cpu")
    x, w, u = (torch.as_tensor(a) for a in (x, w, u))
    s_ = torch.as_tensor(st) if with_status else None
    lhs = (w * sol.residual_jvp_plain(x, u, op, s_)).sum(dim=1)
    rhs = (sol.residual_vjp_plain(x, w, op, sol.vjp_operands(op), sol.MASKED,
                                  s_) * u).sum(dim=1)
    np.testing.assert_allclose(rhs.numpy(), lhs.numpy(), rtol=1e-12)


def test_j2_refuses_an_unknown_mode():
    sys_ = _port(_ref_case("case14"))
    op = sparse_operands(sys_, device="cpu")
    x = torch.ones(1, 2 * sys_.n_bus, dtype=F64)
    with pytest.raises(ValueError, match="residual_vjp mode"):
        sol.residual_vjp(x, x, op, sol.vjp_operands(op), 2)


def test_vjp_operands_pair_each_entry_with_its_other_end():
    sys_ = _port(_ref_case("case_ieee30"))
    op = sparse_operands(sys_, device="cpu")
    vop = sol.vjp_operands(op)
    pair = vop.inc_pair
    assert torch.equal(pair[pair], torch.arange(pair.numel()))
    assert torch.equal(op.inc_code[pair], op.inc_code ^ 1)
    assert torch.equal(vop.inc_gt, op.inc_g[pair])


# ---------------------------------------------------------------------------
# I2's plain version
# ---------------------------------------------------------------------------


def _ref_iterate(rf, ties):
    """The reference's ``_iterate`` (``freedm_tpu/pf/cim.py:157-170``) on
    its own ``assemble_yabc``, over one lane of ``[nb, 3]`` phasors."""
    y, mask_np = ref_assemble_yabc(rf, ties)
    a_c = ref_cplx.as_c(np.linalg.inv(y[3:, 3:]), dtype=jnp.float64)
    mask = jnp.asarray(mask_np[1:], jnp.float64)
    C_ = ref_cplx.C

    def iterate(v, s_pu, v_base):
        live = v.abs2() > 0
        safe_v = v.where(live, 1.0)
        i_inj = (s_pu / safe_v).conj().where(live)
        flat = C_(i_inj.re.reshape(-1), i_inj.im.reshape(-1))
        dv = C_(a_c.re @ flat.re - a_c.im @ flat.im,
                a_c.re @ flat.im + a_c.im @ flat.re)
        v_new = v_base + C_(dv.re.reshape(-1, 3), dv.im.reshape(-1, 3))
        return v_new * mask

    return iterate, np.linalg.inv(y[3:, 3:]), mask_np[1:].reshape(-1)


@pytest.mark.parametrize("tied", [False, True])
def test_i2_plain_version_matches_reference_vjp(tied):
    rf = ref_cases.vvc_9bus()
    iterate, a_inv, mask = _ref_iterate(rf, [REF_TIE_5_8] if tied else [])
    nb, lanes = rf.n_branches, 3
    big_n = 3 * nb
    rng = np.random.default_rng(7)

    def lane_c(scale):
        z = (rng.normal(1.0, scale, (lanes, big_n))
             + 1j * rng.normal(0.0, scale, (lanes, big_n)))
        return z * mask

    v, s, vb, g = lane_c(0.05), lane_c(0.3), lane_c(0.02), lane_c(1.0)
    C_ = ref_cplx.C

    def c(z, b):
        return C_(jnp.asarray(z[b].real.reshape(nb, 3)),
                  jnp.asarray(z[b].imag.reshape(nb, 3)))

    want_v, want_s, want_vb = [], [], []
    for b in range(lanes):
        _, pull = jax.vjp(iterate, c(v, b), c(s, b), c(vb, b))
        gv, gs, gvb = pull(c(g, b))
        want_v.append(np.asarray(gv.re) + 1j * np.asarray(gv.im))
        want_s.append(np.asarray(gs.re) + 1j * np.asarray(gs.im))
        want_vb.append(np.asarray(gvb.re) + 1j * np.asarray(gvb.im))
    h_re, h_im = sol.cim_adjoint_matrix(torch.as_tensor(a_inv.real),
                                        torch.as_tensor(a_inv.imag))

    def t(z):
        return torch.as_tensor(np.ascontiguousarray(z))

    sbar = (torch.zeros(lanes, big_n, dtype=F64),
            torch.zeros(lanes, big_n, dtype=F64))
    vbbar = (torch.zeros_like(sbar[0]), torch.zeros_like(sbar[0]))
    gm = g * mask
    o_re, o_im = sol.cim_vjp(h_re, h_im, t(gm.real), t(gm.imag), t(v.real),
                             t(v.imag), t(s.real), t(s.imag), t(mask),
                             *sbar, *vbbar)
    got_v = (o_re + 1j * o_im).numpy()
    # I2 returns v's cotangent masked (the next step's input); the
    # reference's is 0 on dead phases already (live is false there).
    for got, want in ((got_v, np.stack(want_v).reshape(lanes, -1) * mask),
                      ((sbar[0] + 1j * sbar[1]).numpy(),
                       np.stack(want_s).reshape(lanes, -1)),
                      ((vbbar[0] + 1j * vbbar[1]).numpy(),
                       np.stack(want_v).reshape(lanes, -1) * mask)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(
        (gm).reshape(lanes, nb, 3),
        np.stack(want_vb), rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# The Functions' plain routes against jax.grad of the reference
# ---------------------------------------------------------------------------


def _dense_gate():
    ref = ref_cases.synthetic_mesh(20, seed=10)
    return ref, _port(ref)


def _ref_losses(ref, solve_fixed):
    def loss(q):
        res = solve_fixed(q_inj=q)
        s_f, s_t = ref_branch_flows(ref, res)
        return jnp.sum((s_f + s_t).re)

    return loss


def _port_losses(sys_, solve_fixed):
    def loss(q):
        s_f, s_t = branch_flows(sys_, solve_fixed(q_inj=q))
        return (s_f[0] + s_t[0]).sum()

    return loss


@pytest.mark.parametrize("adjoint", [True, False])
def test_dense_gradient_matches_reference(adjoint):
    """Route B (``adjoint=True``: K1's Jacobian, the LU's adjoint solve and
    J2 in their plain versions) and the unrolled CPU gradient (``False``)
    against ``jax.grad`` of the reference's gate."""
    ref, sys_ = _dense_gate()
    want = jax.grad(_ref_losses(ref, ref_make_newton(ref, max_iter=8)[1]))(
        jnp.asarray(ref.q_inj))
    _, fixed = make_newton_solver(sys_, max_iter=8, device="cpu",
                                  adjoint=adjoint)
    (got,) = _grad(_port_losses(sys_, fixed), sys_.q_inj[None])
    _close(got, want, ROUTE_B_RTOL)


def test_dense_gradient_with_lane_status_matches_reference():
    """Route B with a per-lane status (one Ybus a lane), every output
    differentiated, against ``jax.vmap`` of the reference's ``jax.grad``."""
    ref, sys_ = _dense_gate()
    lanes, n = 3, ref.n_bus
    st = np.ones((lanes, ref.n_branch))
    st[1, 2] = st[2, 5] = 0.0
    scale = np.linspace(0.9, 1.1, lanes)[:, None]
    p, q = scale * ref.p_inj, scale * ref.q_inj
    _, rfix = ref_make_newton(ref, max_iter=8)

    def ref_loss(p, q, status):
        r = rfix(p_inj=p, q_inj=q, status=status)
        return (jnp.sum(r.v ** 2) + r.p[ref.slack] + jnp.sum(r.q ** 2)
                + jnp.sum(jnp.sin(r.theta)))

    want = jax.vmap(jax.grad(ref_loss, argnums=(0, 1)))(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(st))
    _, fixed = make_newton_solver(sys_, max_iter=8, device="cpu",
                                  adjoint=True)

    def loss(p, q):
        r = fixed(p_inj=p, q_inj=q, status=st)
        return ((r.v ** 2).sum() + r.p[:, sys_.slack].sum()
                + (r.q ** 2).sum() + torch.sin(r.theta).sum())

    for got, w in zip(_grad(loss, p, q), want):
        assert got.shape == (lanes, n)
        _close(got, w, ROUTE_B_RTOL)


def test_sparse_gradient_matches_reference():
    """Route B on the sparse backend (GMRES on Jᵀ with J2 MASKED, S3 and
    S4 in their plain versions, the transposed LU-kind preconditioner)
    against ``jax.grad`` through the reference's sparse f64 solver."""
    ref, sys_ = _dense_gate()
    want = jax.grad(_ref_losses(ref, ref_make_sparse(
        ref, max_iter=8, precision="f64")[1]))(jnp.asarray(ref.q_inj))
    _, fixed = make_sparse_newton_solver(
        sys_, max_iter=8, precision="f64", device="cpu", adjoint=True,
        precond=build_fdlf_precond(sys_, kind="lu", device="cpu"))
    (got,) = _grad(_port_losses(sys_, fixed), sys_.q_inj[None])
    _close(got, want, ROUTE_B_RTOL)
    assert adj.ADJOINT_STATS["residual"] < adj.ADJOINT_RTOL


@pytest.mark.parametrize("kind", ["lu", "inverse"])
def test_krylov_gradient_matches_reference(kind):
    """Route B on the matrix-free solver (J2 MASKED as the GMRES
    operator) at the reference's gate, on either preconditioner kind."""
    ref = ref_cases.synthetic_mesh(120, seed=4, load_mw=2.0, chord_frac=1.0)
    sys_ = _port(ref)
    _, rfix = ref_make_krylov(ref, max_iter=6, inner_iters=16)
    want = jax.grad(lambda q: rfix(q_inj=q).p[ref.slack])(
        jnp.asarray(ref.q_inj))
    _, fixed = make_krylov_solver(
        sys_, max_iter=6, inner_iters=16, device="cpu", adjoint=True,
        precond=build_fdlf_precond(sys_, kind=kind, device="cpu"))
    r = fixed(q_inj=sys_.q_inj[None])
    assert bool(r.converged.all())
    (got,) = _grad(lambda q: fixed(q_inj=q).p[0, sys_.slack],
                   sys_.q_inj[None])
    _close(got, want, ROUTE_B_RTOL)
    assert adj.ADJOINT_STATS["residual"] < adj.ADJOINT_RTOL
    assert 1 <= adj.ADJOINT_STATS["cycles"] <= adj.ADJOINT_MAX_CYCLES


@pytest.mark.parametrize("adjoint", [True, False])
def test_fdlf_gradient_matches_reference(adjoint):
    """Route A (``FdlfFixed``: the saved half-steps walked back) and the
    unrolled CPU gradient against ``jax.grad`` at case_ieee30, 30
    iterations, in every argument."""
    ref = ref_load_builtin("case_ieee30")
    sys_ = _port(ref)
    _, rfix = ref_make_fdlf(ref, max_iter=30)

    def ref_loss(p, q, v0, th0):
        r = rfix(p_inj=p, q_inj=q, v0=v0, theta0=th0)
        return r.p[ref.slack] + jnp.sum(r.v ** 3) + jnp.sum(r.q * r.theta)

    v0 = np.where(ref.bus_type == REF_PQ, 1.01, ref.v_set)
    th0 = np.full(ref.n_bus, 0.01)
    args = (ref.p_inj, ref.q_inj, v0, th0)
    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in args))
    _, fixed = make_fdlf_solver(sys_, max_iter=30, device="cpu",
                                adjoint=adjoint)

    def loss(p, q, v0, th0):
        r = fixed(p_inj=p, q_inj=q, v0=v0, theta0=th0)
        return (r.p[0, sys_.slack] + (r.v ** 3).sum()
                + (r.q * r.theta).sum())

    for got, w in zip(_grad(loss, *(a[None] for a in args)), want):
        _close(got, w, ROUTE_A_RTOL)


def test_fdlf_gradient_with_lane_status_matches_reference():
    """Route A with per-lane B′/B″ factors (the library LU's adjoint solve
    lane by lane) against ``jax.vmap`` of the reference's ``jax.grad``."""
    ref = ref_load_builtin("case_ieee30")
    sys_ = _port(ref)
    lanes = 3
    st = np.ones((lanes, ref.n_branch))
    st[1, 3] = st[2, 10] = 0.0
    q = np.linspace(0.9, 1.2, lanes)[:, None] * ref.q_inj
    _, rfix = ref_make_fdlf(ref, max_iter=12)
    want = jax.vmap(jax.grad(
        lambda q, s: rfix(q_inj=q, status=s).p[ref.slack]))(
        jnp.asarray(q), jnp.asarray(st))
    _, fixed = make_fdlf_solver(sys_, max_iter=12, device="cpu", adjoint=True)
    (got,) = _grad(lambda q: fixed(q_inj=q, status=st).p[:, sys_.slack].sum(),
                   q)
    _close(got, want, ROUTE_A_RTOL)


@pytest.mark.parametrize("adjoint", [True, False])
def test_cim_gradient_matches_reference(adjoint):
    """Route A (``CimFixed``: I2 an iteration back) and the unrolled CPU
    gradient against ``jax.grad`` of the reference's gate, in the loads
    and the source voltage."""
    rf = ref_cases.vvc_9bus()
    f = cases.vvc_9bus()
    _, rfix = ref_make_cim(rf, ties=[REF_TIE_5_8], max_iter=80)

    def ref_loss(p, q, vs):
        v2 = rfix(ref_cplx.C(p, q), vs).v_node.abs2()
        return jnp.sum((v2[1:] - 1.0) ** 2) + jnp.sum(v2[0])

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(rf.s_load.real), jnp.asarray(rf.s_load.imag),
        jnp.asarray(1.02))
    _, fixed = make_cim_solver(f, ties=[TIE_5_8], max_iter=80, device="cpu",
                               adjoint=adjoint)

    def loss(p, q, vs):
        v = fixed(C(p, q), vs).v_node
        v2 = v.re ** 2 + v.im ** 2
        return ((v2[1:] - 1.0) ** 2).sum() + v2[0].sum()

    got = _grad(loss, f.s_load.real, f.s_load.imag, 1.02)
    for g, w in zip(got, want):
        _close(g, w, ROUTE_A_RTOL)


def test_cim_lanes_gradient_matches_reference_per_lane():
    """Route A over a lane batch: each lane's load gradient equals the
    reference's for that lane."""
    rf = ref_cases.vvc_9bus()
    f = cases.vvc_9bus()
    lanes = 4
    scale = np.linspace(0.7, 1.3, lanes)[:, None, None]
    _, rfix = ref_make_cim(rf, ties=[REF_TIE_5_8], max_iter=40)
    _, fixed = make_cim_solver(f, ties=[TIE_5_8], max_iter=40, device="cpu",
                               adjoint=True)

    def loss(q):
        v = fixed(C(torch.as_tensor(scale * f.s_load.real), q)).v_node
        return ((v.re ** 2 + v.im ** 2) ** 2).sum()

    (got,) = _grad(loss, scale * f.s_load.imag)
    for b in range(lanes):
        want = jax.grad(lambda q: jnp.sum(rfix(ref_cplx.C(
            jnp.asarray(scale[b] * rf.s_load.real), q)).v_node.abs2() ** 2))(
            jnp.asarray(scale[b] * rf.s_load.imag))
        _close(got[b], want, ROUTE_A_RTOL)


# ---------------------------------------------------------------------------
# Routing and refusals
# ---------------------------------------------------------------------------


def test_function_route_choice():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    t = torch.ones(2, requires_grad=True)
    assert not adj.function_route(False, cpu, False, t)
    assert adj.function_route(False, cuda, False, t)
    assert not adj.function_route(False, cuda, True, t)
    assert adj.function_route(True, cpu, True, t)
    assert adj.function_route(True, cuda, True, t)
    assert not adj.function_route(True, cpu, False, t.detach(), None)
    with torch.no_grad():
        assert not adj.function_route(True, cpu, False, t)


@pytest.mark.parametrize("solver", ["dense", "sparse", "fdlf"])
def test_status_that_requires_grad_is_refused(solver):
    ref, sys_ = _dense_gate()
    make = {"dense": make_newton_solver,
            "sparse": make_sparse_newton_solver,
            "fdlf": make_fdlf_solver}[solver]
    _, fixed = make(sys_, max_iter=2, device="cpu", adjoint=True)
    st = torch.ones(1, sys_.n_branch, dtype=F64, requires_grad=True)
    q = torch.as_tensor(sys_.q_inj[None].copy()).requires_grad_(True)
    with pytest.raises(adj.StatusGradientError, match="status"):
        fixed(q_inj=q, status=st)
    # Without the Function the plain versions trace it, as the reference.
    _, unrolled = make(sys_, max_iter=2, device="cpu")
    unrolled(q_inj=q, status=st).v.sum().backward()
    assert st.grad is not None


def test_forward_of_each_function_equals_the_plain_solve():
    """The Functions' forwards are the solvers' own fixed iterations: the
    same bits as without autograd."""
    ref, sys_ = _dense_gate()
    q = torch.as_tensor(sys_.q_inj[None].copy())
    for make in (make_newton_solver, make_fdlf_solver):
        _, fixed = make(sys_, max_iter=5, device="cpu", adjoint=True)
        a = fixed(q_inj=q)
        b = fixed(q_inj=q.clone().requires_grad_(True))
        for name in ("v", "theta", "p", "q", "mismatch"):
            assert torch.equal(getattr(a, name), getattr(b, name).detach())
    f = cases.vvc_9bus()
    _, fixed = make_cim_solver(f, max_iter=10, device="cpu", adjoint=True)
    s = torch.as_tensor(f.s_load)
    a = fixed(s)
    b = fixed(C(s.real.clone().requires_grad_(True), s.imag))
    assert torch.equal(a.v_node.re, b.v_node.re.detach())
    assert torch.equal(a.residual, b.residual)
