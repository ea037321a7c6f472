"""Matrix-free power-injection evaluation — O(n + m), no dense Ybus.

Port of ``make_injection_fn`` (``freedm_tpu/pf/mfree.py:34-65``): the
bus injections evaluated branch-wise — two gathers, four complex
products per branch, two segment sums per part, then the shunts — which
is the Ybus product written as its sparsity pattern.  The arithmetic is
:func:`freedm_tpu_torch.kernels.cache_kernels.branch_injections`, which is
also the plain version of the injection part of kernel C1 (the serving
cache's delta sweep); :func:`delta_operands` builds the operands both
take.  The matrix-free Newton–Krylov solver that the reference builds on
this module is a later slice (ROADMAP item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from freedm_tpu_torch.device import DeviceLike, resolve_device
from freedm_tpu_torch.grid.bus import PQ, SLACK, BusSystem, branch_admittances
from freedm_tpu_torch.kernels.cache_kernels import (DeltaOperands,
                                                    branch_injections)
from freedm_tpu_torch.pf.sparse import jacobian_pattern


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
    operation order.  A per-lane branch ``status`` belongs to DC and N-1
    screening (ROADMAP item 8) and raises."""
    op = delta_operands(sys, device=device)

    def inject(theta, v, status=None):
        if status is not None:
            raise NotImplementedError(
                "per-lane branch status is not ported (ROADMAP.md, module "
                "queue item 8: DC and N-1 screening)"
            )
        return branch_injections(theta, v, op)

    return inject
