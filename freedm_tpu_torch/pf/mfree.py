"""Matrix-free power-injection evaluation — O(n + m), no dense Ybus.

Port of ``make_injection_fn`` (``freedm_tpu/pf/mfree.py:34-65``): the
bus injections evaluated branch-wise — two gathers, four complex
products per branch, two segment sums per part, then the shunts — which
is the Ybus product written as its sparsity pattern.  The arithmetic is
:func:`freedm_tpu_torch.kernels.cache_kernels.branch_injections`, which is
also the plain version of the injection part of kernel C1 (the serving
cache's delta program) and of the injection part of kernel N1 (the SMW
N-1 screen, with a per-lane branch status); :func:`delta_operands`
builds the operands they take.  The matrix-free Newton–Krylov solver
(:func:`freedm_tpu_torch.pf.krylov.make_krylov_solver`) linearizes the
same branch-wise residual: :func:`residual_jvp`.
"""

from __future__ import annotations

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem, branch_admittances
from freedm_tpu_torch.kernels import solver_kernels as sol
from freedm_tpu_torch.kernels.cache_kernels import (DeltaOperands,
                                                    branch_injections)
from freedm_tpu_torch.pf.sparse import jacobian_pattern, sparse_operands


def delta_operands(sys: BusSystem, device: DeviceLike = None) -> DeltaOperands:
    """The branch-wise injection operands of ``sys`` on ``device``
    (``cuda`` unless the CPU is asked for), float64: the incidence list of
    :func:`~freedm_tpu_torch.pf.sparse.jacobian_pattern`, the branch ends,
    the two-port admittances of every branch in service (host float64, as
    :func:`~freedm_tpu_torch.grid.bus.branch_admittances` stamps them),
    the bus shunts and the masks."""
    dev = resolve_device(device)
    pat = jacobian_pattern(sys)
    yff, yft, ytf, ytt = branch_admittances(sys)
    bt = np.asarray(sys.bus_type)

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    def idx(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return DeltaOperands(
        inc_ptr=idx(pat.inc_ptr, torch.int32),
        inc_code=idx(pat.inc_code, torch.int32),
        inc_nbr=idx(pat.inc_nbr, torch.int32),
        f=idx(pat.f, torch.int64), t=idx(pat.t, torch.int64),
        y=vec(np.stack([yff[0], yff[1], yft[0], yft[1], ytf[0], ytf[1],
                        ytt[0], ytt[1]])),
        g_sh=vec(sys.g_shunt), b_sh=vec(sys.b_shunt),
        th_free=vec(bt != SLACK), v_free=vec(bt == PQ),
    )


def make_injection_fn(sys: BusSystem, device: DeviceLike = None):
    """``inject(theta, v, status=None) -> (p_calc, q_calc)`` for ``[n]``
    or ``[B, n]`` float64 tensors: exactly the injections of the
    assembled Ybus (``s_calc``), evaluated branch-wise in the reference's
    operation order.  ``status`` is the 0/1 branch in-service vector,
    ``[m]`` or one row per lane ``[B, m]`` (numpy or tensor): each
    branch's four admittances are scaled by it, as the reference's
    ``branch_admittances(sys, status)`` does."""
    op = delta_operands(sys, device=device)

    def inject(theta, v, status=None):
        if status is not None:
            status = torch.as_tensor(status, dtype=torch.float64,
                                     device=op.y.device)
            if status.shape[-1:] != (op.m,) or status.dim() > 2:
                raise ValueError(f"status must be [{op.m}] or [B, {op.m}], "
                                 f"got {tuple(status.shape)}")
        return branch_injections(theta, v, op, status)

    return inject


def residual_jvp(sys: BusSystem, dtype: torch.dtype = torch.float64,
                 device: DeviceLike = None, plain: bool = False):
    """``jvp(x, u, status=None) -> J u``: the derivative of the masked
    power-flow residual (``where(th_free, P − P_sched, θ) ‖ where(v_free,
    Q − Q_sched, V − V_set)`` on :func:`make_injection_fn`'s injections)
    at ``x = θ ‖ V`` along ``u``, both ``[B, 2n]`` ``dtype`` tensors;
    pinned rows return ``u``'s θ or V entry.  ``status`` (``[m]`` or
    ``[B, m]``) scales each branch's admittances.  On the card this is
    kernel J1 (:func:`~freedm_tpu_torch.kernels.solver_kernels.
    residual_jvp`); ``plain=True`` runs its plain version on any
    device."""
    op = sparse_operands(sys, dtype=dtype, device=device)
    fn = sol.residual_jvp_plain if plain else sol.residual_jvp

    def jvp(x, u, status=None):
        x = torch.as_tensor(x, dtype=dtype, device=op.th_free.device)
        u = torch.as_tensor(u, dtype=dtype, device=op.th_free.device)
        st = None
        if status is not None:
            st = torch.as_tensor(status, dtype=dtype, device=x.device)
            if st.shape[-1:] != (op.m,) or st.dim() > 2:
                raise ValueError(f"status must be [{op.m}] or [B, {op.m}], "
                                 f"got {tuple(st.shape)}")
            st = st.expand(x.shape[0], op.m).contiguous()
        return fn(x.contiguous(), u.contiguous(), op, st)

    return jvp
