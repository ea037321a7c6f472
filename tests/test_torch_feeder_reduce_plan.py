"""Q2 ``qsts_feeder_reduce``'s launch plan, sums and fold, on the CPU.

On the card Q2 runs a scenario on one CTA of 16 warps: ``warps`` warps
a step (``qsts_kernels.feeder_reduce_plan(nb)``) compute the step's
partials side by side, a thread a step combines its warps' partials in
warp order, and one thread folds the steps into the accumulators in step
order.  ``qsts_kernels.feeder_reduce_mirror`` is that kernel on the host;
these tests hold:

- the plan: a function of the branch count alone (never the scenario or
  step count), one warp up to 170 branches, eight at most;
- the mirror's ordered sums bit for bit against the thread order written
  out in plain Python floats (thread j of 32·W adds entries j, j + 32·W,
  ... in turn, each warp's 32 by ``__shfl_down_sync`` from offset 16 to
  1, the warps in order);
- the mirror against ``qsts_feeder_reduce_plain`` at vvc_9bus and
  ``synthetic_radial(2048, load_kw=1.0)`` on every plan: counts,
  iterations and envelope equal, losses and peak within 1e-12 relative;
- the fold: 24 steps in one call and 12 + 12 the same bits, and a
  scenario's bits the same whatever the scenario count.

The ``cuda``-marked tests hold the kernel to the plain version and to the
mirror (run on the card, whose ``torch.sqrt`` rounds as the kernel's
``sqrt``; the CPU's may not) at vvc_9bus × 24·64 and × 24·1536 and
radial2048 × 6·8, bit-identical on repeat and in two launches of half
the steps each.
"""

import inspect
import math

import numpy as np
import pytest
import torch

from freedm_tpu_torch.grid import cases
from freedm_tpu_torch.kernels import qsts_kernels as qk
from freedm_tpu_torch.pf.ladder import LadderResult, make_ladder_solver

DT_MIN, DT_H, LO, HI = 15.0, 0.25, 0.95, 1.05
RTOL = 1e-12  # losses and peak against the plain version's torch.sum order


@pytest.fixture(scope="module")
def feeders():
    return {"vvc_9bus": cases.vvc_9bus(),
            "radial2048": cases.synthetic_radial(2048, seed=0, load_kw=1.0)}


def _solved(f, steps, lanes, seed=6):
    """``steps · lanes`` ladder lanes (timestep-major) at load scales
    0.5-1.3, solved on the CPU."""
    scale = np.random.default_rng(seed).uniform(0.5, 1.3,
                                                (steps * lanes, 1, 1))
    solve, _ = make_ladder_solver(f, device="cpu")
    return solve(scale * f.s_load)


@pytest.fixture(scope="module")
def solved(feeders):
    return {"vvc_9bus": _solved(feeders["vvc_9bus"], 24, 4),
            "radial2048": _solved(feeders["radial2048"], 6, 4)}


def _acc(lanes, seed=7):
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, lanes))

    def i(hi):
        return torch.as_tensor(rng.integers(0, hi, lanes).astype(np.int32))

    return qk.StepAcc(f(0, 5), f(0, 1), i(50), i(5), i(3), f(0.9, 1.1),
                      f(0.9, 1.1), f(0, 1))


def _clone(acc):
    return qk.StepAcc(*(t.clone() for t in acc))


def _lanes(res, rows):
    """The ladder lanes ``rows`` of ``res`` (every field)."""
    def take(x):
        if hasattr(x, "re"):
            return type(x)(x.re[rows], x.im[rows])
        return x[rows]

    return LadderResult(*(take(x) for x in res))


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int64) if x.dtype == torch.float64
                           else x, y.view(torch.int64)
                           if y.dtype == torch.float64 else y)
               for x, y in zip(a, b))


def test_plan_takes_the_branch_count_alone():
    assert list(inspect.signature(qk.feeder_reduce_plan).parameters) == ["nb"]
    assert qk.FEEDER_MAX_WARPS == 8
    assert qk.feeder_reduce_plan(8).warps == 1  # vvc_9bus
    assert qk.feeder_reduce_plan(170).warps == 1
    assert qk.feeder_reduce_plan(171).warps == 2
    assert qk.feeder_reduce_plan(2048).warps == 8
    assert qk.feeder_reduce_plan(10 ** 6).warps == 8
    with pytest.raises(ValueError):
        qk.feeder_reduce_plan(0)


@pytest.mark.parametrize("warps", [1, 2, 8])
@pytest.mark.parametrize("entries", [5, 27, 64, 300])
def test_thread_sums_follow_the_thread_order(warps, entries):
    rng = np.random.default_rng(entries + warps)
    terms = rng.normal(size=(3, entries)) * 10.0 ** rng.integers(-8, 8,
                                                                 (3, entries))
    mask = rng.uniform(size=entries) > 0.3
    for m in (None, mask):
        got = qk._thread_sums(torch.as_tensor(terms),
                              None if m is None else torch.as_tensor(m),
                              warps)
        width = 32 * warps
        for row in range(3):
            acc = [0.0] * width
            for e in range(entries):
                if m is None or m[e]:
                    acc[e % width] = acc[e % width] + float(terms[row, e])
            sums = []
            for w in range(warps):
                x = acc[32 * w:32 * w + 32]
                for o in (16, 8, 4, 2, 1):
                    x = [x[k] + x[k + o] for k in range(o)]
                sums.append(x[0])
            total = sums[0]
            for w in range(1, warps):
                total = total + sums[w]
            assert float(got[row]) == total or (math.isnan(total)
                                                and math.isnan(got[row]))


@pytest.mark.parametrize("warps", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("name", ["vvc_9bus", "radial2048"])
def test_mirror_against_plain(feeders, solved, name, warps):
    f, res = feeders[name], solved[name]
    lanes = 4
    steps = res.iterations.shape[0] // lanes
    op = qk.feeder_reduce_operands(f, "cpu")
    plan = None if warps is None else qk.FeederReducePlan(warps)
    got, want = _clone(_acc(lanes)), _clone(_acc(lanes))
    qk.feeder_reduce_mirror(res, op, got, steps, DT_MIN, DT_H, LO, HI, plan)
    qk.qsts_feeder_reduce_plain(res, op, want, steps, DT_MIN, DT_H, LO, HI)
    for key in ("viol", "it_sum", "it_max", "nonconv", "v_lo", "v_hi"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    for key in ("loss", "peak"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   getattr(want, key).numpy(), rtol=RTOL,
                                   atol=0, err_msg=key)
    assert bool(torch.isfinite(got.loss).all())


def test_fold_same_bits_in_one_call_and_in_two(feeders, solved):
    f, res = feeders["vvc_9bus"], solved["vvc_9bus"]
    lanes, steps = 4, 24
    op = qk.feeder_reduce_operands(f, "cpu")
    one = _clone(_acc(lanes))
    qk.feeder_reduce_mirror(res, op, one, steps, DT_MIN, DT_H, LO, HI)
    two = _clone(_acc(lanes))
    half = steps // 2 * lanes
    qk.feeder_reduce_mirror(_lanes(res, slice(0, half)), op, two, steps // 2,
                            DT_MIN, DT_H, LO, HI)
    qk.feeder_reduce_mirror(_lanes(res, slice(half, None)), op, two,
                            steps // 2, DT_MIN, DT_H, LO, HI)
    assert _same_bits(one, two)


@pytest.mark.parametrize("name", ["vvc_9bus", "radial2048"])
def test_a_scenario_has_its_bits_at_any_scenario_count(feeders, solved,
                                                       name):
    f, res = feeders[name], solved[name]
    lanes = 4
    steps = res.iterations.shape[0] // lanes
    op = qk.feeder_reduce_operands(f, "cpu")
    full = _clone(_acc(lanes))
    qk.feeder_reduce_mirror(res, op, full, steps, DT_MIN, DT_H, LO, HI)
    keep = [1, 3]
    rows = torch.as_tensor([t * lanes + s for t in range(steps)
                            for s in keep])
    part = qk.StepAcc(*(x[keep].clone() for x in _acc(lanes)))
    qk.feeder_reduce_mirror(_lanes(res, rows), op, part, steps, DT_MIN, DT_H,
                            LO, HI)
    assert _same_bits(part, qk.StepAcc(*(x[keep] for x in full)))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


def _solved_on(f, steps, lanes, dev, seed=6):
    scale = np.random.default_rng(seed).uniform(0.5, 1.3,
                                                (steps * lanes, 1, 1))
    solve, _ = make_ladder_solver(f, device=dev)
    return solve(scale * f.s_load)


@pytest.mark.cuda
@pytest.mark.parametrize("name,steps,lanes", [
    ("vvc_9bus", 24, 64), ("vvc_9bus", 24, 1536), ("radial2048", 6, 8)])
def test_q2_kernel_against_plain_and_mirror_on_card(cuda_device, feeders,
                                                    name, steps, lanes):
    """The kernel: counts, iterations and envelope equal to the plain
    version's, losses and peak within 1e-12 relative; the mirror's bits on
    the card's IEEE operations; the same bits on repeat and in two launches
    of half the steps each."""
    f = feeders[name]
    res = _solved_on(f, steps, lanes, cuda_device)
    op = qk.feeder_reduce_operands(f, cuda_device)
    acc0 = qk.StepAcc(*(t.to(cuda_device) for t in _acc(lanes)))
    got, again, want, mir, halves = (_clone(acc0) for _ in range(5))
    qk.qsts_feeder_reduce(res, op, got, steps, DT_MIN, DT_H, LO, HI)
    qk.qsts_feeder_reduce(res, op, again, steps, DT_MIN, DT_H, LO, HI)
    qk.qsts_feeder_reduce_plain(res, op, want, steps, DT_MIN, DT_H, LO, HI)
    qk.feeder_reduce_mirror(res, op, mir, steps, DT_MIN, DT_H, LO, HI)
    half = steps // 2 * lanes
    for rows, n_steps in ((slice(0, half), steps // 2),
                          (slice(half, None), steps - steps // 2)):
        sub = _lanes(res, rows)
        sub = LadderResult(*(type(x)(x.re.contiguous(), x.im.contiguous())
                             if hasattr(x, "re") else x.contiguous()
                             for x in sub))
        qk.qsts_feeder_reduce(sub, op, halves, n_steps, DT_MIN, DT_H, LO, HI)
    torch.cuda.synchronize()
    assert _same_bits(got, again)
    assert _same_bits(got, mir)
    assert _same_bits(got, halves)
    for key in ("viol", "it_sum", "it_max", "nonconv", "v_lo", "v_hi"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    for key in ("loss", "peak"):
        np.testing.assert_allclose(getattr(got, key).cpu().numpy(),
                                   getattr(want, key).cpu().numpy(),
                                   rtol=RTOL, atol=0, err_msg=key)
