"""Q1 ``qsts_bus_reduce``'s launch plan and its order of sums, on the CPU.

On the card Q1 runs a lane on one CTA of ``qsts_kernels.BUS_CTA_THREADS``
threads, which stages every bus's rotated voltage in shared memory where
``qsts_kernels.bus_reduce_plan(n)`` says it fits, walks the branches and
takes the bus pass in one fixed order.  ``qsts_kernels.bus_reduce_mirror``
is that kernel on the host; these tests hold:

- the plan: a function of the bus count alone (never the lane count),
  within the card's 232,448 bytes of shared memory a block at case14,
  case_ieee30, mesh118, mesh2000 and mesh5000, staged up to its capacity;
- the mirror's losses: bit for bit the 256-thread order (thread t adds
  buses t, t + 256, ... in turn, each warp's 32 by ``__shfl_down_sync``
  from offset 16 to 1, the eight warps' sums in warp order), written out
  here in plain Python floats;
- the mirror against ``qsts_bus_reduce_plain``: counts, iterations,
  envelope and peak equal, losses within 1e-12 relative, and each lane's
  bits the same whatever the lane count.
"""

import inspect

import numpy as np
import pytest
import torch

from freedm_tpu_torch.grid.cases import synthetic_mesh
from freedm_tpu_torch.grid.matpower import load_builtin
from freedm_tpu_torch.kernels import qsts_kernels as qk

SMEM = 232_448  # shared memory a block may use on an H100
CASES = ("case14", "case_ieee30", "mesh118", "mesh2000", "mesh5000")


def case_system(name):
    if name.startswith("mesh"):
        return synthetic_mesh(int(name[4:]), seed=1, load_mw=10.0,
                              chord_frac=1.0)
    return load_builtin(name)


@pytest.fixture(scope="module")
def systems():
    return {name: case_system(name) for name in CASES}


def test_plan_takes_the_shape_alone():
    assert list(inspect.signature(qk.bus_reduce_plan).parameters) == ["n"]
    assert qk.bus_reduce_plan(2000) == qk.bus_reduce_plan(2000)
    assert qk.BUS_CTA_THREADS == 512
    with pytest.raises(ValueError):
        qk.bus_reduce_plan(0)


@pytest.mark.parametrize("name", CASES)
def test_plan_fits_every_case(systems, name):
    n = systems[name].n_bus
    plan = qk.bus_reduce_plan(n)
    assert plan.staged  # every bus's rotated voltage in shared memory
    assert plan.smem == qk.bus_reduce_smem(n, True) <= SMEM
    assert plan.smem == 16 * n + 36 * qk.BUS_CTA_THREADS // 32


def test_plan_at_and_past_the_staging_capacity():
    cap = (SMEM - qk.bus_reduce_smem(0, True)) // 16
    assert qk.bus_reduce_plan(cap).staged
    past = qk.bus_reduce_plan(cap + 1)
    assert not past.staged and past.smem == qk.bus_reduce_smem(cap + 1, False)
    assert 14_000 < cap < 15_000


def lane_inputs(sys_, lanes, seed):
    rng = np.random.default_rng(seed)
    n = sys_.n_bus
    v = torch.as_tensor(rng.uniform(0.93, 1.07, (lanes, n)))
    th = torch.as_tensor(rng.normal(0.0, 0.3, (lanes, n)))
    p = torch.as_tensor(rng.normal(0.0, 1.0, (lanes, n)))
    it = torch.as_tensor(rng.integers(1, 9, lanes).astype(np.int32))
    conv = torch.as_tensor(rng.uniform(size=lanes) > 0.2)
    return v, th, p, it, conv


def fresh_acc(lanes, seed):
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, lanes))

    def i(hi):
        return torch.as_tensor(rng.integers(0, hi, lanes).astype(np.int32))

    return qk.StepAcc(f(0, 5), f(0, 1), i(50), i(5), i(3), f(0.9, 1.1),
                      f(0.9, 1.1), f(0, 1))


def clone(acc):
    return qk.StepAcc(*(t.clone() for t in acc))


def bus_pass_sum(p_row):
    """One lane's losses' sum in the kernel's order, in Python floats."""
    part = [0.0] * qk.BUS_THREADS
    for t in range(qk.BUS_THREADS):
        for b in range(t, len(p_row), qk.BUS_THREADS):
            part[t] = part[t] + float(p_row[b])
    total = 0.0
    for w in range(qk.BUS_THREADS // 32):
        x = part[32 * w:32 * w + 32]
        for o in (16, 8, 4, 2, 1):  # a lane past 31 keeps its own value
            x = [x[i] + (x[i + o] if i + o < 32 else x[i]) for i in range(32)]
        total = total + x[0]
    return total


@pytest.mark.parametrize("name,lanes", [("case14", 3), ("mesh118", 4),
                                        ("mesh2000", 2)])
def test_mirror_losses_follow_the_bus_pass_order(systems, name, lanes):
    sys_ = systems[name]
    v, th, p, it, conv = lane_inputs(sys_, lanes, seed=3)
    op = qk.bus_reduce_operands(sys_, "cpu")
    acc = qk.StepAcc(*(torch.zeros_like(t) for t in fresh_acc(lanes, 1)))
    qk.bus_reduce_mirror(v, th, p, it, conv, op, acc, 15.0, 1.0, 0.95, 1.05)
    for s in range(lanes):
        assert acc.loss[s].item() == bus_pass_sum(p[s].numpy())


@pytest.mark.parametrize("name,lanes", [("case14", 1), ("case_ieee30", 5),
                                        ("mesh118", 8), ("mesh2000", 3)])
def test_mirror_against_plain_at_every_lane_count(systems, name, lanes):
    sys_ = systems[name]
    v, th, p, it, conv = lane_inputs(sys_, lanes, seed=lanes)
    v[0, :3] = torch.tensor([0.9, 1.2, 1.0])  # outside the band both ways
    op = qk.bus_reduce_operands(sys_, "cpu")
    acc0 = fresh_acc(lanes, seed=5)
    want = clone(acc0)
    qk.qsts_bus_reduce_plain(v, th, p, it, conv, op, want, 15.0, 0.25, 0.95,
                             1.05)
    got = clone(acc0)
    qk.bus_reduce_mirror(v, th, p, it, conv, op, got, 15.0, 0.25, 0.95, 1.05)
    for field in ("viol", "it_sum", "it_max", "nonconv", "v_lo", "v_hi",
                  "peak"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    np.testing.assert_allclose(got.loss.numpy(), want.loss.numpy(),
                               rtol=1e-12, atol=0)
    one = qk.StepAcc(*(x[:1].clone() for x in acc0))  # lane 0 alone
    qk.bus_reduce_mirror(v[:1], th[:1], p[:1], it[:1], conv[:1], op, one,
                         15.0, 0.25, 0.95, 1.05)
    for a, b in zip(one, got):  # a lane's bits whatever the lane count
        assert torch.equal(a, b[:1])
