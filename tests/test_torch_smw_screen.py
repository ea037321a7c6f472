"""N1 ``smw_screen``: the one-launch SMW N-1 screen's plan, layout and
yardsticks, on the CPU.

On the card N1 runs a whole screen in one launch: a CTA owns
``screen_kernels.smw_plan(n).lanes`` lanes, solves their base triangular
systems itself on the B′/B″ LU pair (C1's substitution order:
``cache_kernels.lu_solve_mirror``) and applies the rank-2 corrections and
mismatch passes between them.  These tests hold, against the JAX package
on the same seeded inputs where it has the function:

- the plan: a function of ``n`` alone, two lanes a CTA within the card's
  232,448 bytes of shared memory a block at case14, case_ieee30,
  mesh118, mesh511 and n = 1024, one lane up to 2880 buses, and the
  spill route (the lanes' vectors in global memory) just past that;
- ``smw_factors``: the kernel's column-major copies, the pivots' inverse
  permutations and U's reciprocal diagonal;
- ``smw_screen_plain`` on the mirror's solves against it on
  ``torch.linalg.lu_solve``: within 1e-12 at case14, case_ieee30 and
  mesh118 × 16 lanes (the mirror rounds each update twice where the
  kernel fuses it: the kernel's algorithm, not its bits);
- ``make_n1_screen(backend="dense", device="cpu")`` against
  ``freedm_tpu.pf.n1.make_n1_screen`` on every secure outage of case14
  and case_ieee30: θ, V within 1e-9 pu, ``converged`` equal;
- the wrapper's checks, which refuse CPU operands for a card launch, wrong
  dtypes, shapes and plans before any launch.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freedm_tpu.grid import cases as ref_cases
from freedm_tpu.grid import matpower as ref_matpower
from freedm_tpu.pf.n1 import make_n1_screen as ref_make_n1_screen
from freedm_tpu_torch.grid.bus import BusSystem
from freedm_tpu_torch.kernels import cache_kernels as ck
from freedm_tpu_torch.kernels import screen_kernels as sck
from freedm_tpu_torch.pf.n1 import (make_n1_screen, secure_outages,
                                    smw_operands)

SMEM = 232_448  # shared memory a block may use on an H100
MAX_ITER = 24  # ServeConfig.n1_max_iter


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


_OPERANDS = {}


def _operands(name):
    if name not in _OPERANDS:
        _OPERANDS[name] = smw_operands(_systems(name)[1], device="cpu")
    return _OPERANDS[name]


def test_plan_takes_the_shape_alone():
    assert list(inspect.signature(sck.smw_plan).parameters) == ["n"]
    assert sck.SCREEN_THREADS == 384
    assert sck.smw_plan(511) == sck.smw_plan(511)
    with pytest.raises(ValueError):
        sck.smw_plan(0)


@pytest.mark.parametrize("name,n", [("case14", 14), ("case_ieee30", 30),
                                    ("mesh118", 118), ("mesh511", 511),
                                    ("n1024", 1024)])
def test_plan_fits_a_block(name, n):
    plan = sck.smw_plan(n)
    assert plan.smem == sck.smw_smem(n, plan.lanes)
    assert plan.smem + sck.SMW_STATIC <= SMEM
    assert plan.whole == (n <= sck.SMW_TILE)
    assert plan.lanes == 2  # two lanes a CTA wherever they fit


def test_plan_past_two_lanes():
    plan = sck.smw_plan(2000)  # one lane a CTA: two do not fit
    assert plan.lanes == 1 and not plan.whole and not plan.spill
    assert sck.smw_smem(2000, 2) + sck.SMW_STATIC > SMEM
    assert plan.smem + sck.SMW_STATIC <= SMEM
    plan = sck.smw_plan(4096)  # not one lane: the vectors spill
    assert plan == sck.SmwPlan(2, False, sck.smw_smem(4096, 2, True), True)
    assert sck.smw_smem(4096, 1) + sck.SMW_STATIC > SMEM


@pytest.mark.parametrize("n", [sck.SMW_SHARED_MAX_N,
                               sck.SMW_SHARED_MAX_N + 1, 5000, 20000])
def test_plan_spills_past_the_shared_memory(n):
    plan = sck.smw_plan(n)
    assert plan.smem + sck.SMW_STATIC <= SMEM
    shared = sck.smw_smem(n, 1) + sck.SMW_STATIC <= SMEM
    assert shared == (n <= sck.SMW_SHARED_MAX_N == 2880)
    assert plan.spill == (not shared)
    if plan.spill:  # the tiles alone in shared memory, two lanes a CTA
        assert plan.lanes == 2 and plan.smem == 8 * 2 * 64 * 64
        rows = -(-n // 64) * 64
        assert sck.smw_work(n, 2) == 2 * (rows + 4 * n) + 2 * rows


@pytest.mark.parametrize("name", ["case14", "mesh118"])
def test_factors_are_the_kernels_layout(name):
    lu_p, lu_q, _ = _operands(name)
    fac = sck.smw_factors(lu_p, lu_q)
    n = lu_p[0].shape[0]
    assert fac.lda % 2 == 0 and fac.lda >= n
    for h, (lu_mat, piv) in enumerate((lu_p, lu_q)):
        assert torch.equal(fac.lu[h][:, :n], lu_mat.mT)
        perm = ck.lu_permutation(piv)
        assert torch.equal(fac.pinv[h].long()[perm], torch.arange(n))
        assert fac.pinv[h].dtype == torch.int32
        assert torch.equal(fac.rdiag[h], 1.0 / torch.diagonal(lu_mat))


@pytest.mark.parametrize("name", ["case14", "case_ieee30", "mesh118"])
def test_mirror_screen_against_lu_solve_screen(name):
    _, sys = _systems(name)
    lu_p, lu_q, op = _operands(name)
    ks = torch.as_tensor(np.resize(np.asarray(secure_outages(sys)), 16))
    want = sck.smw_screen_plain(ks, op, lu_p, lu_q, MAX_ITER)
    got = sck.smw_screen_plain(ks, op, lu_p, lu_q, MAX_ITER,
                               solve=ck.lu_solve_mirror)
    for g, w, what in zip(got, want, ("theta", "v", "p", "q", "err")):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12, msg=what)


@pytest.mark.parametrize("name", ["case14", "case_ieee30"])
def test_dense_screen_matches_reference(name):
    ref, sys = _systems(name)
    ks = secure_outages(sys)
    want = ref_make_n1_screen(ref, backend="dense", max_iter=MAX_ITER,
                              dtype=jnp.float64)(jnp.asarray(ks))
    got = make_n1_screen(sys, backend="dense", max_iter=MAX_ITER,
                         device="cpu")(ks)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    for k in ("v", "theta"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-9, err_msg=k)


def test_screen_on_the_cpu_is_the_plain_loop():
    _, sys = _systems("case_ieee30")
    lu_p, lu_q, op = _operands("case_ieee30")
    ks = torch.as_tensor(secure_outages(sys)[:5])
    fac = sck.smw_factors(lu_p, lu_q)
    got = sck.smw_screen(ks, op, fac, 3)
    want = sck.smw_screen_plain(ks, op, lu_p, lu_q, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrapper_refuses_bad_inputs_before_any_launch():
    lu_p, lu_q, op = _operands("case14")
    fac = sck.smw_factors(lu_p, lu_q)
    ks = torch.tensor([2, 3], dtype=torch.int64)
    plan = sck.smw_plan(op.n)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    sck.smw_screen_check(ks, op, fac, MAX_ITER, plan, cpu)  # all on the CPU
    with pytest.raises(ValueError, match="on cuda"):  # CPU operands
        sck.smw_screen_check(ks, op, fac, MAX_ITER, plan, cuda)
    with pytest.raises(ValueError, match="int64"):
        sck.smw_screen_check(ks.int(), op, fac, MAX_ITER, plan, cpu)
    with pytest.raises(ValueError, match="at least one outage"):
        sck.smw_screen_check(ks[:0], op, fac, MAX_ITER, plan, cpu)
    with pytest.raises(ValueError, match="max_iter"):
        sck.smw_screen_check(ks, op, fac, -1, plan, cpu)
    spill = sck.SmwPlan(2, False, sck.smw_smem(op.n, 2, True), True)
    sck.smw_screen_check(ks, op, fac, MAX_ITER, spill, cpu)  # any n
    for bad in (plan._replace(lanes=3), plan._replace(lanes=4),
                plan._replace(smem=plan.smem + 8),
                plan._replace(lanes=8, smem=sck.smw_smem(op.n, 8)),
                sck.smw_plan(118), plan._replace(spill=True),
                spill._replace(whole=True), spill._replace(
                    lanes=1, smem=sck.smw_smem(op.n, 1, True))):
        with pytest.raises(ValueError, match="no plan"):
            sck.smw_screen_check(ks, op, fac, MAX_ITER, bad, cpu)
    with pytest.raises(ValueError, match="int32"):
        sck.smw_screen_check(ks, op, fac._replace(pinv=fac.pinv.long()),
                             MAX_ITER, plan, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        sck.smw_screen_check(ks, op, fac._replace(
            lu=(fac.lu[0][:, :-2], fac.lu[1])), MAX_ITER, plan, cpu)
    with pytest.raises(ValueError, match="leading dimension"):
        sck.smw_screen_check(ks, op, fac._replace(lda=op.n + 1), MAX_ITER,
                             plan, cpu)
    with pytest.raises(ValueError, match="float64"):
        sck.smw_screen_check(ks, op._replace(zm=op.zm.float()), fac,
                             MAX_ITER, plan, cpu)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sck.smw_screen(ks.to("meta"), op, fac, MAX_ITER)
