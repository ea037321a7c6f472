"""S1 ``sparse_assemble`` in each of its modes, and S2 ``sparse_matvec`` on
the layout S1 writes, against the JAX package and the dense port.

The values of one Newton step lie in incidence-list order (``ev [B, 4,
2m]``: per list entry ``a, c, cv, av`` of the entry's side).  On the CPU
the wrappers run their plain versions; the ``cuda``-marked tests hold the
kernels to those on the card (``chip_smoke.py`` does so at full size).
The reference's ``_assemble`` is a closure inside its solver factory, so
its P and Q are held to ``freedm_tpu.pf.newton.s_calc`` and its mismatch
to the dense port's K1 (held to the reference in
``tests/test_torch_newton.py``).  Inputs are seeded numpy, float64.
Tolerances: 1e-12 absolute on float64 values (sums in another order);
float32 values within one float32 rounding of the float64 ones; the
relations between the modes are bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.grid.bus import branch_admittances as ref_branch_admittances
from freedm_tpu.grid.bus import ybus_dense as ref_ybus_dense
from freedm_tpu.pf.newton import s_calc as ref_s_calc
from freedm_tpu_torch.grid.bus import BusSystem, ybus_dense
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import sparse_kernels as sk
from freedm_tpu_torch.pf import sparse

F64 = torch.float64
CASES = ("mesh118", "case14")
MODES = (sk.FULL, sk.VALUES_F32, sk.RESIDUAL)
LANES = 3


def _ref_system(name):
    if name == "mesh118":
        return ref_cases.synthetic_mesh(118, seed=1, load_mw=10.0,
                                        chord_frac=1.0)
    return ref_matpower.load_builtin(name)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """``(reference system, port system, operands, x, p_sched, q_sched)``
    with seeded random states and schedules of ``LANES`` lanes."""
    ref = _ref_system(request.param)
    sys = BusSystem.from_arrays(dataclasses.asdict(ref))
    n = sys.n_bus
    rng = np.random.default_rng(7 + n)
    x = np.concatenate([rng.uniform(-0.2, 0.2, (LANES, n)),
                        rng.uniform(0.95, 1.05, (LANES, n))], axis=1)
    ps = rng.normal(size=(LANES, n))
    qs = rng.normal(size=(LANES, n))
    op = sparse.sparse_operands(sys, device="cpu")
    return (ref, sys, op, torch.as_tensor(x), torch.as_tensor(ps),
            torch.as_tensor(qs))


def _k1(sys, op, x, ps, qs):
    """The dense port's K1 plain version: ``(J [B, 2n, 2n], f [B, 2n])``."""
    y_re, y_im = ybus_dense(sys, device="cpu")
    return nk.newton_assemble_plain(x, y_re, y_im, ps, qs, op.th_free,
                                    op.v_free, op.v_set)


def _p_q(out, mode):
    if mode == sk.RESIDUAL:
        return out[0], out[1]
    return out[1][:, 4], out[1][:, 5]


@pytest.mark.parametrize("mode", MODES)
def test_plain_modes_match_reference_injections_and_mismatch(case, mode):
    """Each mode's P and Q against the reference's ``s_calc`` and its f
    against K1, at 1e-12 where they are float64 (the float32 values of
    VALUES_F32 within a float32 rounding)."""
    ref, sys, op, x, ps, qs = case
    n = sys.n_bus
    out = sk.sparse_assemble(x, ps, qs, op, mode)
    p, q = _p_q(out, mode)
    y = ref_ybus_dense(ref, dtype=jnp.float64)
    for lane in range(LANES):
        want_p, want_q = ref_s_calc(y, jnp.asarray(x[lane, :n].numpy()),
                                    jnp.asarray(x[lane, n:].numpy()))
        for got, want in ((p[lane], want_p), (q[lane], want_q)):
            want = np.asarray(want)
            atol = (1e-12 if got.dtype == F64
                    else 1e-12 + 2 ** -24 * float(np.abs(want).max()))
            np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                       atol=atol)
    _, want_f = _k1(sys, op, x, ps, qs)
    assert out[2].dtype == F64
    np.testing.assert_allclose(out[2].numpy(), want_f.numpy(), rtol=0,
                               atol=1e-12)


def test_values_f32_is_the_full_fill_cast_bit_for_bit(case):
    _, _, op, x, ps, qs = case
    ev, bv, f = sk.sparse_assemble(x, ps, qs, op, sk.FULL)
    ev32, bv32, f32 = sk.sparse_assemble(x, ps, qs, op, sk.VALUES_F32)
    assert ev32.dtype == bv32.dtype == torch.float32 and f32.dtype == F64
    assert chip_smoke.same_bits(torch, ev32, ev.to(torch.float32))
    assert chip_smoke.same_bits(torch, bv32, bv.to(torch.float32))
    assert chip_smoke.same_bits(torch, f32, f)


def test_residual_is_the_full_fill_sliced_bit_for_bit(case):
    _, sys, op, x, ps, qs = case
    _, bv, f = sk.sparse_assemble(x, ps, qs, op, sk.FULL)
    p, q, f3 = sk.sparse_assemble(x, ps, qs, op, sk.RESIDUAL)
    assert p.shape == q.shape == (LANES, sys.n_bus)
    assert chip_smoke.same_bits(torch, p, bv[:, 4].contiguous())
    assert chip_smoke.same_bits(torch, q, bv[:, 5].contiguous())
    assert chip_smoke.same_bits(torch, f3, f)


def test_bus_sums_are_the_ordered_sums_of_the_written_values(case):
    """P and Q are the sums, in incidence-list order (from side, then to
    side), of the c/a values the fill writes — ``chip_smoke.py``'s check
    of the kernel, here on the plain version."""
    _, _, op, x, ps, qs = case
    ev, bv, _ = sk.sparse_assemble(x, ps, qs, op, sk.FULL)
    p, q = chip_smoke.ordered_bus_sums(torch, op, ev, x)
    assert chip_smoke.same_bits(torch, p, bv[:, 4].contiguous())
    assert chip_smoke.same_bits(torch, q, bv[:, 5].contiguous())


def test_values_in_list_order_are_the_dense_jacobian(case):
    """Entry r of bus i's list (far end j) holds J[i, j], J[i, n+j],
    −J[n+i, j] and J[n+i, n+j] as (a, cv, c, av); summed over parallel
    branches and with bv's four diagonals they give K1's Jacobian on every
    free row, within 1e-12 of its largest entry."""
    _, sys, op, x, ps, qs = case
    n = sys.n_bus
    ev, bv, _ = sk.sparse_assemble(x, ps, qs, op, sk.FULL)
    assert ev.shape == (LANES, 4, 2 * sys.n_branch)
    i, j = op.inc_rows(), op.inc_nbr.long()
    jac = torch.zeros(LANES, 2 * n, 2 * n, dtype=F64)
    a, c, cv, av = ev.unbind(1)
    for rows, cols, vals in ((i, j, a), (i, n + j, cv), (n + i, j, -c),
                             (n + i, n + j, av)):
        jac.index_put_((torch.arange(LANES)[:, None], rows[None], cols[None]),
                       vals, accumulate=True)
    d = torch.arange(n)
    for k, (rows, cols) in enumerate(((d, d), (d, n + d), (n + d, d),
                                      (n + d, n + d))):
        jac[:, rows, cols] += bv[:, k]
    want, _ = _k1(sys, op, x, ps, qs)
    free = torch.cat([op.th_free, op.v_free]) > 0
    np.testing.assert_allclose(jac[:, free].numpy(), want[:, free].numpy(),
                               rtol=0, atol=1e-12 * float(want.abs().max()))


def test_matvec_plain_on_list_order_matches_dense_jacobian(case):
    """S2's plain version on S1's layout: J·u within 1e-12 (relative to
    |J·u|) of K1's Jacobian times u, pinned rows included."""
    _, sys, op, x, ps, qs = case
    ev, bv, _ = sk.sparse_assemble(x, ps, qs, op, sk.FULL)
    u = torch.as_tensor(np.random.default_rng(3).normal(
        size=(LANES, 2 * sys.n_bus)))
    got = sk.sparse_matvec(ev, bv, u, op)
    jac, _ = _k1(sys, op, x, ps, qs)
    want = (jac @ u[:, :, None])[:, :, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


def test_operands_carry_each_entrys_side_admittance(case):
    """``inc_g``/``inc_b`` hold the reference's ``yft`` at a branch's
    from-end entry and ``ytf`` at its to-end entry."""
    ref, _, op, _, _, _ = case
    _, yft, ytf, _ = ref_branch_admittances(ref, dtype=jnp.float64)
    code = op.inc_code.numpy()
    edge, to = code >> 1, (code & 1).astype(bool)
    assert op.inc_ptr.numpy()[-1] == 2 * ref.n_branch
    for got, fwd, back in ((op.inc_g, yft.re, ytf.re),
                           (op.inc_b, yft.im, ytf.im)):
        want = np.where(to, np.asarray(back)[edge], np.asarray(fwd)[edge])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,dtype,match", [
    (sk.VALUES_F32, torch.float32, "VALUES_F32"),
    (7, F64, "unknown"),
])
def test_mode_arguments_are_checked(case, mode, dtype, match):
    _, _, op, x, ps, qs = case
    op = op.to_dtype(dtype)
    with pytest.raises(ValueError, match=match):
        sk.sparse_assemble(x.to(dtype), ps.to(dtype), qs.to(dtype), op, mode)


# ---------------------------------------------------------------------------
# On the card (skipped on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_assemble_modes_match_plain_versions_on_card(cuda_device, case,
                                                     dtype):
    """Each S1 mode against its plain version within ``chip_smoke``'s
    ``SPARSE_TOL``, the modes' bit relations and ordered sums
    (``chip_smoke.compare_assemble``), one launch a call counted under
    its mode, and S2 on the kernel's values against its plain version."""
    _, sys, op, x, ps, qs = case
    op = sparse.sparse_operands(sys, dtype=dtype, device=cuda_device)
    x, ps, qs = (t.to(cuda_device, dtype) for t in (x, ps, qs))
    chip_smoke.compare_assemble(torch, sk, op, x, ps, qs, f"{dtype}")
    sk.reset_launches()
    modes = [sk.FULL, sk.RESIDUAL] + ([sk.VALUES_F32] if dtype == F64
                                      else [])
    for mode in modes:
        sk.sparse_assemble(x, ps, qs, op, mode)
    counts = sk.assemble_launches()
    assert sk.launches()["sparse_assemble"] == len(modes)
    assert all(counts[name] == (getattr(sk, name) in modes)
               for name in counts)
    ev, bv, _ = sk.sparse_assemble(x, ps, qs, op)
    u = torch.randn_like(x)
    tol = chip_smoke.SPARSE_TOL[str(dtype)[6:]][0]
    got = sk.sparse_matvec(ev, bv, u, op)
    want = sk.sparse_matvec_plain(ev, bv, u, op)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    torch.cuda.synchronize()
