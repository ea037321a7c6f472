"""The reverse modes of the fixed solves on the card: J2
``residual_vjp`` in both modes, with and without status, and I2
``cim_vjp`` (a call, and its walk over a backward's saved iterates in
one launch) against their plain PyTorch versions (float64, 1e-10 of the
largest entry), bit-identical on repeat; J2 against J1 by ``⟨w, J u⟩ =
⟨Jᵀ w, u⟩``; J1 and J2 under every plan forced through ``plan=`` (the
staged route's lanes a CTA and CTAs a lane, and the wide route, which
also takes a shape past the staging capacity by default), each plan the
wide route's bits, and a lane's bits equal at widths 1, 64 and 256; and
each autograd Function of ``freedm_tpu_torch.pf.adjoint``
— dense, sparse (f64 and mixed) and matrix-free Newton, FDLF and the CIM
— on its kernel route against its plain route on the card (rtol 1e-9),
with J2 or I2 launched.  Every test needs a CUDA card and skips without
one (``chip_smoke.py`` phase 27 runs these checks at the full widths).
No JAX: ``tests/test_torch_adjoint.py`` holds the plain versions and the
plain routes to the reference on the CPU."""

import numpy as np
import pytest
import torch

from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.grid import cases
from freedm_tpu_torch.grid.cases import synthetic_mesh, synthetic_radial
from freedm_tpu_torch.grid.matpower import load_builtin
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf.cim import assemble_yabc, make_cim_solver
from freedm_tpu_torch.pf.fdlf import make_fdlf_solver
from freedm_tpu_torch.pf.krylov import build_fdlf_precond, make_krylov_solver
from freedm_tpu_torch.pf.newton import make_newton_solver
from freedm_tpu_torch.pf.sparse import (make_sparse_newton_solver,
                                        sparse_operands)

F64 = torch.float64
ATOL = 1e-10
ROUTE_RTOL = 1e-9
TIE_5_8 = (5, 8, cases.Z_CODES_9BUS[0] / (1000.0 * 12.47**2 / 1000.0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


def system(name):
    if name.startswith("mesh"):
        return synthetic_mesh(int(name[4:]), seed=1, load_mw=10.0,
                              chord_frac=1.0)
    return load_builtin(name)


def _same_bits(a, b):
    ints = torch.int64 if a.dtype == F64 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def _residual_plans(n, m, lanes, dtype, status):
    """J1's and J2's plans at this shape: the default, the wide route, and
    the staged route at every lanes-a-CTA that fits with one, two and
    every slice's CTA a lane group."""
    plans = {sol.residual_plan(n, m, lanes, dtype, status),
             sol.residual_plan(n, m, lanes, dtype, status, route=sol.WIDE)}
    per = sol.residual_stage_bytes(n, m, dtype, status)
    slices = -(-n // sol.RES_SLICE)
    for lpc in range(1, min(sol.RES_MAX_LANES, sol.RES_SMEM // per) + 1):
        for cpl in {1, min(2, slices), slices}:
            plans.add(sol.residual_plan(n, m, lanes, dtype, status, lpc,
                                        cpl))
    return sorted(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["case14", "case_ieee30", "mesh118"])
@pytest.mark.parametrize("lanes", [1, 3, 64])
def test_j2_matches_plain_version(cuda_device, name, lanes):
    sys_ = system(name)
    n, m = sys_.n_bus, sys_.n_branch
    rng = np.random.default_rng(lanes)
    x = torch.cat([torch.as_tensor(rng.normal(0, 0.2, (lanes, n))),
                   torch.as_tensor(rng.uniform(0.9, 1.1, (lanes, n)))],
                  1).to(cuda_device)
    w = torch.as_tensor(rng.normal(size=(lanes, 2 * n)), device=cuda_device)
    u = torch.as_tensor(rng.normal(size=(lanes, 2 * n)), device=cuda_device)
    st = torch.as_tensor((rng.random((lanes, m)) > 0.1).astype(np.float64),
                         device=cuda_device)
    op = sparse_operands(sys_, device=cuda_device)
    vop = sol.vjp_operands(op)
    for mode in (sol.MASKED, sol.FULL):
        for s_ in (None, st):
            sol.reset_launches()
            got = sol.residual_vjp(x, w, op, vop, mode, s_)
            again = sol.residual_vjp(x, w, op, vop, mode, s_)
            torch.cuda.synchronize()
            assert sol.launches()["residual_vjp"] == 2
            assert sol.route_launches()["residual_vjp"][sol.STAGED] == 2
            want = sol.residual_vjp_plain(x, w, op, vop, mode, s_)
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= ATOL * scale
            assert _same_bits(got, again)
            wide = sol.residual_plan(n, m, lanes, F64, s_ is not None,
                                     route=sol.WIDE)
            ref = sol.residual_vjp(x, w, op, vop, mode, s_, plan=wide)
            for plan in _residual_plans(n, m, lanes, F64, s_ is not None):
                k = sol.residual_vjp(x, w, op, vop, mode, s_, plan=plan)
                k2 = sol.residual_vjp(x, w, op, vop, mode, s_, plan=plan)
                assert float((k - want).abs().max()) <= ATOL * scale, plan
                assert _same_bits(k, k2), plan
                assert _same_bits(k, ref), plan
            if mode == sol.MASKED:
                lhs = (w * sol.residual_jvp(x, u, op, s_)).sum(dim=1)
                rhs = (got * u).sum(dim=1)
                torch.testing.assert_close(rhs, lhs, rtol=1e-11, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes", [
    (name, lanes) for name in ("case14", "case_ieee30", "mesh118")
    for lanes in (1, 3, 64)] + [("mesh7300", 1)])
@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_j1_matches_plain_version(cuda_device, name, lanes, dtype):
    """J1 under every plan against its plain version (float64 1e-10,
    float32 1e-3 of the largest entry above 1), bit-identical on repeat
    and the wide route's bits; mesh7300's lane (n > 7264) does not fit a
    CTA in float64 and takes the wide route by default."""
    sys_ = system(name)
    n, m = sys_.n_bus, sys_.n_branch
    rng = np.random.default_rng(lanes + 11)
    x = torch.cat([torch.as_tensor(rng.normal(0, 0.2, (lanes, n))),
                   torch.as_tensor(rng.uniform(0.9, 1.1, (lanes, n)))],
                  1).to(cuda_device, dtype)
    u = torch.as_tensor(rng.normal(size=(lanes, 2 * n)), device=cuda_device,
                        dtype=dtype)
    st = torch.as_tensor((rng.random((lanes, m)) > 0.1).astype(np.float64),
                         device=cuda_device, dtype=dtype)
    op = sparse_operands(sys_, dtype=dtype, device=cuda_device)
    atol = ATOL if dtype == F64 else 1e-3
    for s_ in (None, st):
        status = s_ is not None
        default = sol.residual_plan(n, m, lanes, dtype, status)
        sol.reset_launches()
        got = sol.residual_jvp(x, u, op, s_)
        torch.cuda.synchronize()
        assert sol.launches()["residual_jvp"] == 1
        assert sol.route_launches()["residual_jvp"][default.route] == 1
        if name == "mesh7300" and dtype == F64:
            assert default.route == sol.WIDE
        want = sol.residual_jvp_plain(x, u, op, s_)
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= atol * scale
        ref = sol.residual_jvp(x, u, op, s_, plan=sol.residual_plan(
            n, m, lanes, dtype, status, route=sol.WIDE))
        assert _same_bits(got, ref)
        for plan in _residual_plans(n, m, lanes, dtype, status):
            k = sol.residual_jvp(x, u, op, s_, plan=plan)
            k2 = sol.residual_jvp(x, u, op, s_, plan=plan)
            assert float((k - want).abs().max()) <= atol * scale, plan
            assert _same_bits(k, k2), plan
            assert _same_bits(k, ref), plan


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["jvp", "vjp_masked", "vjp_full"])
@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_residual_lane_bits_at_every_width_and_plan(cuda_device, kernel,
                                                    dtype):
    """mesh2000 (the krylov lane batch's case): lanes 0 and 1 give the
    same bits in launches of 2, 64 and 256 lanes under every plan, with
    and without status."""
    sys_ = synthetic_mesh(2000, seed=4, load_mw=2.0, chord_frac=1.0)
    n, m = sys_.n_bus, sys_.n_branch
    rng = np.random.default_rng(22)
    full = 256
    x = torch.cat([torch.as_tensor(rng.normal(0, 0.1, (full, n))),
                   torch.as_tensor(rng.uniform(0.95, 1.05, (full, n)))],
                  1).to(cuda_device, dtype)
    u = torch.as_tensor(rng.normal(size=(full, 2 * n)), device=cuda_device,
                        dtype=dtype)
    st = torch.as_tensor((rng.random((full, m)) > 0.05).astype(np.float64),
                         device=cuda_device, dtype=dtype)
    op = sparse_operands(sys_, dtype=dtype, device=cuda_device)
    vop = sol.vjp_operands(op)

    def call(width, s_, plan):
        xs, us = x[:width].contiguous(), u[:width].contiguous()
        ss = None if s_ is None else s_[:width].contiguous()
        if kernel == "jvp":
            return sol.residual_jvp(xs, us, op, ss, plan=plan)
        mode = sol.MASKED if kernel == "vjp_masked" else sol.FULL
        return sol.residual_vjp(xs, us, op, vop, mode, ss, plan=plan)

    for s_ in (None, st):
        rows = []
        for width in (2, 64, full):
            for plan in _residual_plans(n, m, width, dtype, s_ is not None):
                rows.append((width, plan, call(width, s_, plan)[:2]))
        torch.cuda.synchronize()
        for width, plan, r in rows:
            assert _same_bits(r, rows[0][2]), (width, plan)


def _cim_inputs(f, ties, lanes, device, seed=0):
    y, mask_np = assemble_yabc(f, ties)
    a_inv = np.linalg.inv(y[3:, 3:])
    mask = mask_np[1:].reshape(-1)
    big_n = 3 * f.n_branches
    rng = np.random.default_rng(seed)

    def lane_c(loc, scale):
        z = (rng.normal(loc, scale, (lanes, big_n))
             + 1j * rng.normal(0.0, scale, (lanes, big_n))) * mask
        return (torch.as_tensor(z.real.copy(), device=device),
                torch.as_tensor(z.imag.copy(), device=device))

    h = sol.cim_adjoint_matrix(torch.as_tensor(a_inv.real, device=device),
                               torch.as_tensor(a_inv.imag, device=device))
    return (h, lane_c(0.0, 1.0), lane_c(1.0, 0.05), lane_c(0.0, 0.3),
            torch.as_tensor(mask, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("feeder", ["vvc_9bus", "radial300"])
@pytest.mark.parametrize("lanes", [1, 8, 64, 67])
def test_i2_matches_plain_version(cuda_device, feeder, lanes):
    f = cases.vvc_9bus() if feeder == "vvc_9bus" else synthetic_radial(
        300, seed=0, load_kw=1.0)
    ties = [TIE_5_8] if feeder == "vvc_9bus" else []
    h, g, v, s, mask = _cim_inputs(f, ties, lanes, cuda_device)
    outs = []
    for fn in (sol.cim_vjp, sol.cim_vjp_plain, sol.cim_vjp):
        acc = [torch.full_like(v[0], 0.5) for _ in range(4)]
        o = fn(*h, *g, *v, *s, mask, *acc)
        outs.append((*o, *acc))
    torch.cuda.synchronize()
    for k, p, again in zip(*outs):
        scale = max(1.0, float(p.abs().max()))
        assert float((k - p).abs().max()) <= ATOL * scale
        assert _same_bits(k, again)


def _walk_inputs(f, ties, lanes, steps, device, seed=0):
    """I2's walk operands: random iterates near 1 pu (0 where the phase
    mask is), loads, a masked cotangent and the staged Aᴴ."""
    h, g, _, s, mask = _cim_inputs(f, ties, lanes, device, seed)
    big_n = mask.shape[0]
    rng = np.random.default_rng(seed + 1)
    vs = torch.as_tensor(rng.normal(1.0, 0.05, (steps + 1, 2, lanes, big_n)),
                         device=device) * mask
    return h, g, vs, s, mask


@pytest.mark.cuda
@pytest.mark.parametrize("feeder", ["vvc_9bus", "radial300"])
@pytest.mark.parametrize("lanes", [1, 3, 64, 65])
def test_i2_walk_matches_chained_calls(cuda_device, feeder, lanes):
    """I2's walk over 12 saved iterates in one launch: within ``ATOL`` of
    the chained plain calls, the bits of the chained single calls of its
    kernel, and bit-identical on repeat (3 and 65 lanes: ragged lane
    tiles)."""
    f = cases.vvc_9bus() if feeder == "vvc_9bus" else synthetic_radial(
        300, seed=0, load_kw=1.0)
    ties = [TIE_5_8] if feeder == "vvc_9bus" else []
    steps = 12
    h, g, vs, s, mask = _walk_inputs(f, ties, lanes, steps, cuda_device)
    args = (*h, *g, vs, *s, mask, steps)
    sol.reset_launches()
    got = sol.cim_vjp_walk(*args)
    torch.cuda.synchronize()
    assert sol.launches()["cim_vjp"] == 1
    again = sol.cim_vjp_walk(*args)
    want = sol.cim_vjp_walk_plain(*args)
    chain = [torch.zeros_like(s[0]), torch.zeros_like(s[0]), g[0].clone(),
             g[1].clone()]
    gk = g
    for k in reversed(range(steps)):
        gk = sol.cim_vjp(*h, *gk, vs[k, 0], vs[k, 1], *s, mask, *chain)
    torch.cuda.synchronize()
    for k, p, a2, c in zip(got, want, again, chain):
        scale = max(1.0, float(p.abs().max()))
        assert float((k - p).abs().max()) <= ATOL * scale
        assert _same_bits(k, a2)
        assert _same_bits(k, c)


@pytest.mark.cuda
def test_cim_backward_launches_i2_once(cuda_device):
    """A CIM ``solve_fixed`` backward on the card walks every iteration in
    one I2 launch."""
    f = cases.vvc_9bus()
    s = np.linspace(0.7, 1.3, 5)[:, None, None] * f.s_load[None]
    fixed = make_cim_solver(f, ties=[TIE_5_8], max_iter=40,
                            device=cuda_device)[1]
    p = torch.as_tensor(s.real, device=cuda_device).requires_grad_(True)
    q = torch.as_tensor(s.imag, device=cuda_device)
    v = fixed(C(p, q)).v_node
    loss = ((v.re ** 2 + v.im ** 2) ** 2).sum()
    sol.reset_launches()
    (g,) = torch.autograd.grad(loss, p)
    torch.cuda.synchronize()
    assert sol.launches()["cim_vjp"] == 1
    assert bool(torch.isfinite(g).all())


def _grads(fixed, loss, args):
    ts = [a.clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(loss(fixed, *ts), ts)


def _route_pair(make, loss, args, kernel):
    """Gradients of the kernel route and the plain route of one Function
    on the card; the kernel route must launch ``kernel``."""
    sol.reset_launches()
    got = _grads(make(False), loss, args)
    torch.cuda.synchronize()
    assert sol.launches()[kernel] > 0
    want = _grads(make(True), loss, args)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(
            g, w, rtol=ROUTE_RTOL, atol=ROUTE_RTOL * float(w.abs().max()))


def _pq(sys_, lanes, device):
    scale = torch.linspace(0.8, 1.2, lanes, dtype=F64, device=device)[:, None]
    return (scale * torch.as_tensor(sys_.p_inj, device=device),
            scale * torch.as_tensor(sys_.q_inj, device=device))


def _newton_loss(fixed, p, q):
    r = fixed(p_inj=p, q_inj=q)
    return ((r.v ** 2).sum() + r.p[:, 0].sum() + (r.q ** 2).sum()
            + torch.sin(r.theta).sum())


@pytest.mark.cuda
def test_dense_route_matches_plain_route(cuda_device):
    sys_ = system("mesh118")
    st = np.ones((4, sys_.n_branch))
    st[np.arange(1, 4), np.arange(1, 4)] = 0.0

    def make(plain):
        fixed = make_newton_solver(sys_, max_iter=8, device=cuda_device,
                                   plain=plain, adjoint=True)[1]
        return lambda **kw: fixed(status=st, **kw)

    _route_pair(make, _newton_loss, _pq(sys_, 4, cuda_device),
                "residual_vjp")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_sparse_route_matches_plain_route(cuda_device, precision):
    sys_ = system("mesh118")
    pc = build_fdlf_precond(sys_, kind="lu", device=cuda_device)

    def make(plain):
        return make_sparse_newton_solver(
            sys_, max_iter=8, precision=precision, device=cuda_device,
            plain=plain, adjoint=True, precond=pc)[1]

    _route_pair(make, _newton_loss, _pq(sys_, 4, cuda_device),
                "residual_vjp")


@pytest.mark.cuda
def test_krylov_route_matches_plain_route(cuda_device):
    sys_ = synthetic_mesh(120, seed=4, load_mw=2.0, chord_frac=1.0)

    def make(plain):
        return make_krylov_solver(sys_, max_iter=6, inner_iters=16,
                                  precision="f64", device=cuda_device,
                                  plain=plain, adjoint=True)[1]

    _route_pair(make, _newton_loss, _pq(sys_, 3, cuda_device),
                "residual_vjp")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 16])
def test_fdlf_route_matches_plain_route(cuda_device, lanes):
    sys_ = system("case_ieee30")

    def make(plain):
        return make_fdlf_solver(sys_, max_iter=30, device=cuda_device,
                                plain=plain, adjoint=True)[1]

    _route_pair(make, _newton_loss, _pq(sys_, lanes, cuda_device),
                "residual_vjp")


@pytest.mark.cuda
def test_cim_route_matches_plain_route(cuda_device):
    f = cases.vvc_9bus()
    s = np.linspace(0.7, 1.3, 8)[:, None, None] * f.s_load[None]

    def make(plain):
        return make_cim_solver(f, ties=[TIE_5_8], max_iter=80,
                               device=cuda_device, plain=plain,
                               adjoint=True)[1]

    def loss(fixed, p, q, vs):
        v = fixed(C(p, q), vs).v_node
        return ((v.re ** 2 + v.im ** 2 - 1.0) ** 2).sum()

    args = (torch.as_tensor(s.real, device=cuda_device),
            torch.as_tensor(s.imag, device=cuda_device),
            torch.full((8,), 1.02, dtype=F64, device=cuda_device))
    _route_pair(make, loss, args, "cim_vjp")


@pytest.mark.cuda
def test_solve_fixed_differentiates_on_card_by_default(cuda_device):
    """The default takes the Function on the card: no refusal, and the
    gradient equals the plain route's."""
    sys_ = system("case_ieee30")
    p, q = _pq(sys_, 2, cuda_device)
    for make in (make_newton_solver, make_fdlf_solver):
        _, fixed = make(sys_, device=cuda_device)
        _, plain = make(sys_, device=cuda_device, plain=True, adjoint=True)
        got = _grads(fixed, _newton_loss, (p, q))
        want = _grads(plain, _newton_loss, (p, q))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=ROUTE_RTOL,
                                       atol=ROUTE_RTOL * float(w.abs().max()))
