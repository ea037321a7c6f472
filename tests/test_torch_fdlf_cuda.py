"""F1 ``fdlf_half_step``'s warp form on the card — one launch a
half-step — against its plain PyTorch version in its three modes (INIT,
THETA, V), float64 (1e-10) and float32 (1e-3), with one Ybus of every
lane at 1, 2 and 3 lanes (below ``TILED_MIN_LANES``) and with a per-lane
Ybus; frozen and fixed lanes; bit-identical on repeat and across the two
product forms' shared order (K2's per-lane warp form against its plain
version); the refusal above the buses its shared memory holds.  Every test
needs a CUDA card and skips without one (``chip_smoke.py`` runs these
checks at the full widths).  No JAX: the plain version is held to the
reference on the CPU by ``tests/test_torch_fdlf.py``, which also tests
``fdlf_warp_plan``."""

import numpy as np
import pytest
import torch

from freedm_tpu_torch.grid.bus import PQ, SLACK, ybus_dense
from freedm_tpu_torch.grid.cases import synthetic_mesh
from freedm_tpu_torch.grid.matpower import load_builtin
from freedm_tpu_torch.kernels import newton_kernels as nk
from freedm_tpu_torch.kernels import solver_kernels as sol

ATOL = {torch.float64: 1e-10, torch.float32: 1e-3}


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


def inputs(sys_, lanes, dtype, device, per_lane, seed=0):
    rng = np.random.default_rng(seed)
    n = sys_.n_bus

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    y_re, y_im = ybus_dense(sys_, dtype=dtype, device=device)
    if per_lane:  # each lane its own Ybus: scaled copies
        scale = t(rng.uniform(0.8, 1.2, (lanes, 1, 1)))
        y_re, y_im = (scale * y_re).contiguous(), (scale * y_im).contiguous()
    x = torch.cat([t(rng.normal(0, 0.1, (lanes, n))),
                   t(rng.uniform(0.95, 1.05, (lanes, n)))], 1)
    ps = t(rng.normal(size=(lanes, n)))
    bt = np.asarray(sys_.bus_type)
    d_th = t(rng.normal(0, 1e-3, (n, lanes))).T  # strided, as lu_solve's
    d_v = t(rng.normal(0, 1e-3, (lanes, n)))
    return (x, (y_re, y_im), ps, 0.3 * ps, t(bt != SLACK), t(bt == PQ),
            d_th, d_v)


def run(fn, x, y, ps, qs, thf, vf, d_th, d_v, active, fixed, modes):
    lanes, n = ps.shape
    xx = x.clone()
    dp, dq = torch.zeros_like(ps), torch.zeros_like(ps)
    err = torch.full((lanes,), float("inf"), dtype=x.dtype, device=x.device)
    it = torch.zeros(lanes, dtype=torch.int32, device=x.device)
    act = active.clone()
    tol = torch.full((1,), 1e-8, dtype=x.dtype, device=x.device)
    for mode in modes:
        d = {sol.INIT: None, sol.THETA: d_th, sol.VHALF: d_v}[mode]
        fn(mode, xx, d, y[0], y[1], ps, qs, thf, vf, dp, dq, err, it, act,
           tol, 3, fixed)
    return xx, dp, dq, err, it, act


def close(a, b, atol):
    if a.dtype in (torch.bool, torch.int32):
        return torch.equal(a, b)
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and float(
        (a - b).nan_to_num().abs().max()) <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lanes,per_lane", [(1, False), (2, False),
                                            (3, False), (3, True),
                                            (5, True)])
@pytest.mark.parametrize("name", ["case14", "mesh118", "mesh311"])
def test_warp_form_matches_plain_in_every_mode(cuda_device, name, lanes,
                                               per_lane, dtype):
    sys_ = system(name)
    x, y, ps, qs, thf, vf, d_th, d_v = inputs(sys_, lanes, dtype, cuda_device,
                                              per_lane)
    active = torch.as_tensor(np.arange(lanes) % 3 != 1, device=cuda_device)
    for fixed in (False, True):
        for modes in ((sol.INIT,), (sol.INIT, sol.THETA),
                      (sol.INIT, sol.THETA, sol.VHALF),
                      (sol.INIT, sol.THETA, sol.VHALF, sol.THETA,
                       sol.VHALF)):
            got = run(sol.fdlf_half_step, x, y, ps, qs, thf, vf, d_th, d_v,
                      active, fixed, modes)
            again = run(sol.fdlf_half_step, x, y, ps, qs, thf, vf, d_th,
                        d_v, active, fixed, modes)
            want = run(sol.fdlf_half_step_plain, x, y, ps, qs, thf, vf, d_th,
                       d_v, active, fixed, modes)
            torch.cuda.synchronize()
            for a, b, c in zip(got, want, again):
                assert close(a, b, ATOL[dtype]), (modes, fixed)
                assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))


@pytest.mark.cuda
def test_warp_form_launches_once_a_half_step(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    sys_ = system("mesh118")
    x, y, ps, qs, thf, vf, d_th, d_v = inputs(sys_, 1, torch.float64,
                                              cuda_device, False)
    active = torch.ones(1, dtype=torch.bool, device=cuda_device)
    run(sol.fdlf_half_step, x, y, ps, qs, thf, vf, d_th, d_v, active, False,
        (sol.INIT, sol.THETA, sol.VHALF))
    torch.cuda.synchronize()
    sol.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(sol.fdlf_half_step, x, y, ps, qs, thf, vf, d_th, d_v, active,
            False, (sol.INIT, sol.THETA, sol.VHALF))
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if "fdlf" in e.key or "finish" in e.key or "prepass" in e.key]
    assert sol.mode_launches()["fdlf_half_step"] == {"INIT": 1, "THETA": 1,
                                                     "V": 1}
    if names:  # the trace holds device events
        assert all("fdlf_warp_kernel" in k for k in names), names
        assert sum(e.count for e in prof.key_averages()
                   if "fdlf_warp_kernel" in e.key) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k2_per_lane_warp_form_matches_plain(cuda_device, dtype):
    sys_ = system("mesh118")
    x, y, ps, qs, thf, vf, _, _ = inputs(sys_, 3, dtype, cuda_device, True)
    v_set = torch.ones(sys_.n_bus, dtype=dtype, device=cuda_device)
    got = nk.power_injections(x, y[0], y[1], ps, qs, thf, vf, v_set)
    again = nk.power_injections(x, y[0], y[1], ps, qs, thf, vf, v_set)
    want = nk.power_injections_plain(x, y[0], y[1], ps, qs, thf, vf, v_set)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert float((a - b).abs().max()) <= ATOL[dtype]
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_warp_form_refuses_more_buses_than_shared_memory_holds(cuda_device):
    n = sol.FDLF_WARP_MAX_N[torch.float32] + 1
    z = torch.zeros(1, n, dtype=torch.float32, device=cuda_device)
    y = torch.zeros(1, 1, dtype=torch.float32, device=cuda_device).expand(
        n, n)
    with pytest.raises(ValueError, match="at most"):
        sol.fdlf_half_step(sol.INIT, torch.zeros(1, 2 * n,
                                                 device=cuda_device),
                           None, y, y, z, z, z[0], z[0], z, z,
                           torch.zeros(1, device=cuda_device),
                           torch.zeros(1, dtype=torch.int32,
                                       device=cuda_device),
                           torch.ones(1, dtype=torch.bool,
                                      device=cuda_device),
                           torch.zeros(1, device=cuda_device), 3, False)
