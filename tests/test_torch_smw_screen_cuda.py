"""N1 ``smw_screen`` on the card: the whole SMW N-1 screen in one launch
against its plain versions (no JAX here; ``tests/test_torch_smw_screen.py``
holds the plain versions to the JAX package on the CPU).

- every secure outage of case14 and case_ieee30, mesh118 × 64 and mesh511
  × 1, 64 and 256, 24 iterations: against ``smw_screen_plain`` on the
  mirror's solves (``cache_kernels.lu_solve_mirror``, the kernel's
  substitution order; each update rounded twice where the kernel fuses
  it) within 1e-12, up to 64 lanes; against it on ``lu_solve`` within
  1e-9 pu with equal ``converged`` flags; bit-identical on repeat; one
  launch a screen;
- a lane's bits the same alone, in a batch of 256 and on every plan,
  the spill route (the lanes' vectors in global memory) included;
- mesh2900 × 4, just past the 2880 buses whose vectors fit the shared
  memory, on the spill route by default: against both plain screens as
  above.

Skipped without a card (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

from freedm_tpu_torch.grid.cases import synthetic_mesh
from freedm_tpu_torch.grid.matpower import load_builtin
from freedm_tpu_torch.kernels import cache_kernels as ck
from freedm_tpu_torch.kernels import screen_kernels as sck
from freedm_tpu_torch.pf.n1 import secure_outages, smw_operands

ITERS = 24  # ServeConfig.n1_max_iter
TOL = 1e-8  # default_tol(float64): the screen's converged flag
MIRROR_LANES = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(name):
    if name.startswith("mesh"):
        return synthetic_mesh(int(name[4:]), seed=1, load_mw=10.0,
                              chord_frac=1.0)
    return load_builtin(name)


def _setup(name, lanes, dev):
    sys_ = _case(name)
    sec = np.asarray(secure_outages(sys_), np.int64)
    ks = torch.as_tensor(sec if lanes is None else np.resize(sec, lanes),
                         device=dev)
    lu_p, lu_q, op = smw_operands(sys_, device=dev)
    return ks, op, lu_p, lu_q, sck.smw_factors(lu_p, lu_q)


def _bits(a, b):
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes", [
    ("case14", None), ("case_ieee30", None), ("mesh118", 64),
    ("mesh511", 1), ("mesh511", 64), ("mesh511", 256), ("mesh2900", 4)])
def test_screen_matches_plain_on_card(cuda_device, name, lanes):
    ks, op, lu_p, lu_q, fac = _setup(name, lanes, cuda_device)
    assert sck.smw_plan(op.n).spill == (op.n > sck.SMW_SHARED_MAX_N)
    sck.reset_launches()
    got = sck.smw_screen(ks, op, fac, ITERS)
    assert sck.launches()["smw_screen"] == 1
    again = sck.smw_screen(ks, op, fac, ITERS)
    assert all(_bits(a, b) for a, b in zip(got, again))
    want = sck.smw_screen_plain(ks, op, lu_p, lu_q, ITERS)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-9)
    assert torch.equal(got[4] < TOL, want[4] < TOL)
    m = min(len(ks), MIRROR_LANES)
    mirror = sck.smw_screen_plain(ks[:m], op, lu_p, lu_q, ITERS,
                                  solve=ck.lu_solve_mirror)
    for g, w in zip(got, mirror):
        torch.testing.assert_close(g[:m], w, rtol=0, atol=1e-12)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lane_bits_at_every_width_and_plan(cuda_device):
    ks, op, _, _, fac = _setup("mesh511", 256, cuda_device)
    wide = sck.smw_screen(ks, op, fac, ITERS)
    alone = sck.smw_screen(ks[:1], op, fac, ITERS)
    assert all(_bits(a[:1], b) for a, b in zip(wide, alone))
    one = sck.SmwPlan(1, False, sck.smw_smem(op.n, 1))
    spill = sck.SmwPlan(2, False, sck.smw_smem(op.n, 2, True), True)
    for plan in (one, spill):
        by_plan = sck.smw_screen(ks[:64], op, fac, ITERS, plan=plan)
        assert all(_bits(a[:64], b) for a, b in zip(wide, by_plan)), plan
    ks30, op30, _, _, fac30 = _setup("case_ieee30", None, cuda_device)
    ref = sck.smw_screen(ks30, op30, fac30, ITERS)
    for plan in (sck.SmwPlan(1, True, sck.smw_smem(op30.n, 1)),
                 sck.SmwPlan(2, False, sck.smw_smem(op30.n, 2)),
                 sck.SmwPlan(2, False, sck.smw_smem(op30.n, 2, True), True)):
        got = sck.smw_screen(ks30, op30, fac30, ITERS, plan=plan)
        assert all(_bits(a, b) for a, b in zip(ref, got)), plan
    torch.cuda.synchronize()
