"""Unbalanced three-phase power flow for weakly meshed feeders — the
current-injection method (CIM) on the 3×3-block Ybus.

Port of ``freedm_tpu/pf/cim.py``.  Each branch's per-phase impedance
block is inverted on its present phases and stamped into a ``[3 nn, 3
nn]`` block admittance matrix (:func:`assemble_yabc`), with optional tie
branches between any two nodes — a closed tie switch the radial ladder
cannot represent.  With the substation's phases pinned at the
120°-displaced source phasors, the load-node system is iterated as

    V ← V_base + Y_LL⁻¹ · conj(S_load / V),   V_base = −Y_LL⁻¹ Y_LS V_s,

``Y_LL⁻¹`` computed once at build time by host LAPACK in float64 (a
solver constant, as in the reference) and each iteration one complex
``[3 nb, 3 nb]`` product over the lanes: kernel I1
(:func:`~freedm_tpu_torch.kernels.solver_kernels.cim_iterate`) on the
card, which fuses the injection, the product, ``V_base +``, the phase
mask and each lane's ``max |ΔV|``.  The lane axis is written out: loads
may carry a leading ``[B]`` axis.  Phasors are ``(re, im)`` pairs of real
tensors (:class:`~freedm_tpu_torch.cplx.C`); no complex tensor reaches
the card.  Constant-power loads only, like the ladder.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from freedm_tpu_torch import cplx
from freedm_tpu_torch.cplx import C
from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.feeder import Feeder
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.pf import adjoint as adj
from freedm_tpu_torch.pf.ladder import SOURCE_UNIT
from freedm_tpu_torch.pf.newton import any_active

Tensor = torch.Tensor

#: A tie branch: ``(node_a, node_b, z_pu [3, 3] complex)``.
Tie = Tuple[int, int, np.ndarray]


class CimResult(NamedTuple):
    """Power-flow solution, per unit: ``v_node [..., nn, 3]`` (node 0 the
    substation); per lane the iterations (int32), the converged flag and
    the last iteration's ``max |ΔV|``.  The lane axis is there when the
    loads had one."""

    v_node: C
    iterations: Tensor
    converged: Tensor
    residual: Tensor


def _block_admittance(z_block: np.ndarray) -> np.ndarray:
    """Invert a [3, 3] impedance block on its present phases (a phase is
    absent where its diagonal entry is zero); absent rows and columns are
    zero, so they stamp nothing."""
    present = np.abs(np.diag(z_block)) > 0
    y = np.zeros((3, 3), dtype=np.complex128)
    if present.any():
        idx = np.flatnonzero(present)
        y[np.ix_(idx, idx)] = np.linalg.inv(z_block[np.ix_(idx, idx)])
    return y


def assemble_yabc(feeder: Feeder,
                  ties: Sequence[Tie] = ()) -> Tuple[np.ndarray, np.ndarray]:
    """The ``[3 nn, 3 nn]`` block Ybus (complex128, host) and the
    node-phase mask ``[nn, 3]`` (1 where the node-phase exists).  Absent
    node-phases get an identity row and column, so the matrix stays
    regular."""
    nn = feeder.n_nodes
    y = np.zeros((nn * 3, nn * 3), dtype=np.complex128)

    def stamp(a: int, b: int, yb: np.ndarray):
        sl_a = slice(a * 3, a * 3 + 3)
        sl_b = slice(b * 3, b * 3 + 3)
        y[sl_a, sl_a] += yb
        y[sl_b, sl_b] += yb
        y[sl_a, sl_b] -= yb
        y[sl_b, sl_a] -= yb

    for i in range(feeder.n_branches):
        stamp(int(feeder.from_node[i]), i + 1,
              _block_admittance(feeder.z_pu[i]))
    for a, b, z in ties:
        if not (0 <= a < nn and 0 <= b < nn) or a == b:
            raise ValueError(f"bad tie endpoints ({a}, {b})")
        stamp(int(a), int(b), _block_admittance(np.asarray(z, np.complex128)))

    mask = np.ones((nn, 3), dtype=np.float64)
    mask[1:] = np.asarray(feeder.phase_mask, np.float64)
    absent = np.flatnonzero(mask.reshape(-1) == 0)
    y[absent, :] = 0.0
    y[:, absent] = 0.0
    y[absent, absent] = 1.0
    return y, mask


def make_cim_solver(
    feeder: Feeder,
    ties: Sequence[Tie] = (),
    tol: Optional[float] = None,
    max_iter: int = 60,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
    plain: bool = False,
    adjoint: bool = False,
):
    """Build the current-injection solvers of a (possibly meshed) feeder.

    Returns ``(solve, solve_fixed)``, each ``(s_load_kva, v_source_pu=None)
    -> CimResult`` with the ladder solver's conventions: loads in kW +
    j·kvar per branch to-node and phase as a complex array or tensor, or a
    ``(re, im)`` pair, ``[nb, 3]`` or ``[B, nb, 3]``; ``v_source_pu`` a
    scalar or ``[B]`` (default the feeder's).  ``solve`` iterates each
    lane while ``it < max_iter`` and its last ``max |ΔV|`` (infinite
    before the first) is ``>= tol``; ``solve_fixed`` runs exactly
    ``max_iter`` iterations on every lane, differentiable in the loads and
    ``v_source_pu`` — on the CPU and with ``plain=True`` by autograd through
    I1's plain version, on the card by
    :class:`~freedm_tpu_torch.pf.adjoint.CimFixed`, which saves every
    iterate and walks them back on I2 (``adjoint`` as in
    :func:`~freedm_tpu_torch.pf.newton.make_newton_solver`).  ``ties``
    lists extra branches
    ``(node_a, node_b, z_pu_3x3)``; none gives the radial solve, which
    matches the ladder's fixed point.  ``tol=None`` is 1e-9 in float64
    and 1e-5 in float32.  ``plain=True`` runs I1's plain version on any
    device; ``device`` is ``cuda`` unless the CPU is asked for.
    """
    dev = resolve_device(device)
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"dtype must be float64 or float32, got {dtype}")
    if tol is None:
        tol = 1e-9 if dtype == torch.float64 else 1e-5
    tol = float(tol)
    max_iter = int(max_iter)
    nb = feeder.n_branches
    big_n = 3 * nb

    y, mask_np = assemble_yabc(feeder, ties)
    a_inv = np.linalg.inv(y[3:, 3:])  # solver constant: build-time LAPACK
    base_op = -a_inv @ y[3:, :3]  # V_base = base_op @ V_s

    def real(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    a_re, a_im = real(a_inv.real), real(a_inv.imag)
    adjoint_a = []  # I2's staged Aᴴ, at the first differentiated solve
    base_re, base_im = real(base_op.real), real(base_op.imag)
    mask = real(mask_np[1:].reshape(-1))
    tol_t = torch.full((1,), tol, dtype=dtype, device=dev)
    s_base = feeder.s_base_per_phase_kva
    unit = cplx.as_c(SOURCE_UNIT, dtype, dev)
    on_card = dev.type == "cuda" and not plain

    def prep(s_load_kva, v_source_pu):
        s = cplx.as_c(s_load_kva, dtype, dev)
        batched = s.re.dim() == 3
        if not batched:
            s = C(s.re[None], s.im[None])
        if s.re.dim() != 3 or tuple(s.re.shape[1:]) != (nb, 3):
            raise ValueError(f"s_load_kva must be [{nb}, 3] or [B, {nb}, "
                             f"3], got {tuple(s.re.shape)}")
        lanes = s.re.shape[0]
        # The iteration adds Y⁻¹·I with I drawn from the network: loads
        # enter with a minus.
        s_pu = -(s / s_base)
        vs = feeder.v_source_pu if v_source_pu is None else v_source_pu
        vs = torch.as_tensor(vs, dtype=dtype, device=dev)
        if vs.dim() == 0:
            vs = vs.expand(lanes)
        if tuple(vs.shape) != (lanes,):
            raise ValueError(f"v_source_pu must be a scalar or [{lanes}], "
                             f"got {tuple(vs.shape)}")
        v_s = C(unit.re[None, :] * vs[:, None], unit.im[None, :] * vs[:, None])
        vb = C((v_s.re @ base_re.T - v_s.im @ base_im.T) * mask,
               (v_s.im @ base_re.T + v_s.re @ base_im.T) * mask)
        flat = C(s_pu.re.reshape(lanes, big_n).contiguous(),
                 s_pu.im.reshape(lanes, big_n).contiguous())
        return flat, v_s, C(vb.re.contiguous(), vb.im.contiguous()), batched

    def finish(v_s: C, v: C, it, err, batched):
        lanes = v.re.shape[0]
        v_node = C(torch.cat([v_s.re[:, None, :],
                              v.re.reshape(lanes, nb, 3)], dim=1),
                   torch.cat([v_s.im[:, None, :],
                              v.im.reshape(lanes, nb, 3)], dim=1))
        res = CimResult(v_node, it, err < tol, err)
        if batched:
            return res
        return CimResult(C(v_node.re[0], v_node.im[0]), it[0], res.converged[0],
                         err[0])

    def iterate(v_re, v_im, s_re, s_im, vb_re, vb_im, err, it, active,
                out):
        args = (s_re, s_im, vb_re, vb_im, mask, err, it, active, tol_t,
                max_iter, True)
        if plain:
            n_re, n_im = sol.cim_iterate_plain(a_re, a_im, v_re, v_im, *args)
            out[0].copy_(n_re)
            out[1].copy_(n_im)
            return out
        return sol.cim_iterate(a_re, a_im, v_re, v_im, *args, out=out)

    def run_adjoint(s_load_kva, v_source_pu):
        s, v_s, vb, batched = prep(s_load_kva, v_source_pu)
        if not adjoint_a:
            adjoint_a.append(sol.cim_adjoint_matrix(a_re, a_im))
        h_re, h_im = adjoint_a[0]
        route = adj.CimRoute(iterate,
                             sol.cim_vjp_walk_plain if plain
                             else sol.cim_vjp_walk,
                             h_re, h_im, mask, max_iter)
        v_re, v_im, err = adj.CimFixed.apply(s.re, s.im, vb.re, vb.im,
                                             route)
        it = torch.full((s.re.shape[0],), max_iter, dtype=torch.int32,
                        device=dev)
        return finish(v_s, C(v_re, v_im), it, err, batched)

    def run(s_load_kva, v_source_pu, fixed):
        s, v_s, vb, batched = prep(s_load_kva, v_source_pu)
        lanes = s.re.shape[0]
        it = torch.zeros(lanes, dtype=torch.int32, device=dev)
        err = torch.full((lanes,), float("inf"), dtype=dtype, device=dev)
        active = (torch.ones(lanes, dtype=torch.bool, device=dev) if fixed
                  else (it < max_iter) & (err >= tol_t))
        args = (s.re, s.im, vb.re, vb.im, mask, err, it, active, tol_t,
                max_iter, fixed)
        v = vb
        if not on_card:  # the plain iteration, differentiable on the CPU
            for _ in range(max_iter):
                if not fixed and not any_active(active):
                    break
                v = C(*sol.cim_iterate_plain(a_re, a_im, v.re, v.im, *args))
            return finish(v_s, v, it, err, batched)
        v = C(vb.re.clone(), vb.im.clone())
        spare = C(torch.empty_like(v.re), torch.empty_like(v.im))
        for _ in range(max_iter):
            if not fixed and not any_active(active):  # one sync a step
                break
            out = sol.cim_iterate(a_re, a_im, v.re, v.im, *args,
                                  out=(spare.re, spare.im))
            v, spare = C(*out), v
        return finish(v_s, v, it, err, batched)

    def solve(s_load_kva, v_source_pu=None) -> CimResult:
        return run(s_load_kva, v_source_pu, fixed=False)

    def solve_fixed(s_load_kva, v_source_pu=None) -> CimResult:
        tensors = [t for t in _tensors(s_load_kva, v_source_pu)
                   if isinstance(t, Tensor)]
        if adj.function_route(adjoint, dev, plain, *tensors):
            return run_adjoint(s_load_kva, v_source_pu)
        return run(s_load_kva, v_source_pu, fixed=True)

    return solve, solve_fixed


def _tensors(*args):
    for a in args:
        if isinstance(a, tuple):
            yield from a
        else:
            yield a


def kcl_residual_kva(feeder: Feeder, ties: Sequence[Tie], result: CimResult,
                     s_load_kva=None) -> np.ndarray:
    """Host KCL check: ``|S_injected(V) − S_specified|`` in kVA per
    load-node phase, ``[nb, 3]`` (``[B, nb, 3]`` for a batched result).
    Independent of the solver's iteration: it re-derives the injections
    from the assembled Ybus and the solved voltages.  ``s_load_kva`` must
    be the loads of the solve (default the feeder's own)."""
    y, mask_np = assemble_yabc(feeder, ties)
    v_node = result.v_node.to_numpy()
    single = v_node.ndim == 2
    lanes = v_node[None] if single else v_node
    spec = -np.asarray(feeder.s_load if s_load_kva is None else s_load_kva)
    spec = np.broadcast_to(spec, (len(lanes),) + spec.shape[-2:])
    out = []
    for v3, want in zip(lanes, spec):
        v = v3.reshape(-1)
        s = v * np.conj(y @ v)  # pu per-phase injection into the network
        s_kva = s.reshape(-1, 3)[1:] * feeder.s_base_per_phase_kva
        out.append(np.abs((s_kva - want) * mask_np[1:]))
    return out[0] if single else np.stack(out)
