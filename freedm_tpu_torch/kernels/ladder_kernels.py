"""Wrappers, plain versions and launch counters of the ladder kernels.

==========================  =============================================  =====
wrapper                     replaces                                       route
==========================  =============================================  =====
:func:`ladder_solve` (L1)   ``freedm_tpu/pf/ladder.py`` ``_solve``          CUDA
                            (:184) and ``_solve_fixed`` (:209): the
                            iteration ``_sweep`` (:138) and
                            ``_root_err`` (:148) on the preorder
                            ``euler_sweeps`` of ``pf/sweeps.py``
                            (:124, :204-226)
:func:`ladder_vjp` (L2)     the reverse mode of ``_solve_fixed`` (the       CUDA
                            ``jax.value_and_grad`` of
                            ``freedm_tpu/modules/vvc.py:117``)
==========================  =============================================  =====

Both live in ``csrc/ladder.cu`` (float64 and float32).  A wrapper given
CPU tensors runs its plain PyTorch version; given CUDA tensors it
launches its kernel or raises.  Each launch counts in :data:`LAUNCHES`.
L1 takes one of two routes, chosen by :func:`ladder_plan` from the
branch count and dtype alone (so a lane's result is the same bits
whatever the lanes beside it): up to :func:`cluster_capacity` branches a
lane is one thread-block cluster whose
shared memory holds its state, above that one CTA a lane with its state
in device memory.

The kernels work in DFS preorder (:meth:`Feeder.reorder_preorder`), on
:class:`LadderOperands` made once per feeder.  Lanes are ``[B, nb, 3]``
:class:`~freedm_tpu_torch.cplx.C` pairs: the loads ``s`` in pu and the
per-lane source phasors ``v0 [B, 3]``.  L1 runs every iteration of a
solve in one launch — in ``solve`` mode each lane stops on its own at
``err < eps`` or ``max_iter``; in ``fixed`` mode every lane runs
``max_iter`` iterations and, with ``save=True``, keeps each iteration's
input voltages (``[max_iter, B, nb, 6]``, re ‖ im, 8 · 6 · nb · B ·
max_iter bytes in float64: 0.6 GB at 10k buses × 64 lanes × 20) for L2.
L2 walks those iterates backwards in one launch and returns the
cotangent of ``s``.  :class:`LadderFixed` is the ``torch.autograd``
function whose forward is L1 in fixed mode and whose backward is L2.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from freedm_tpu_torch.cplx import C, einsum
from freedm_tpu_torch.grid.feeder import Feeder
from freedm_tpu_torch.kernels import build

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"ladder_solve": 0, "ladder_vjp": 0}
_launch_lock = threading.Lock()


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


class LadderOperands(NamedTuple):
    """A preordered feeder's tree on one device: the phase ``mask [nb,
    3]``, the impedances ``z_re``, ``z_im [nb, 3, 3]`` (pu), ``root
    [nb]`` (1 on substation-fed branches), in the working dtype; the
    subtree ends ``tout [nb]`` and the groups ``{k : tout_k = t}`` as CSR
    ``grp_ptr [nb + 1]``, ``grp_idx`` in increasing ``k`` (int32); ``zt``,
    the impedances in the cluster route's layout (``_cluster_z``)."""

    mask: Tensor
    z_re: Tensor
    z_im: Tensor
    root: Tensor
    tout: Tensor
    grp_ptr: Tensor
    grp_idx: Tensor
    zt: Tensor

    @property
    def nb(self) -> int:
        return int(self.mask.shape[0])


def subtree_ends(parent: np.ndarray) -> np.ndarray:
    """``tout [nb]`` of a preordered forest: the end of each branch's
    subtree interval ``[i, tout_i)``.  Raises if ``parent`` is not in
    DFS preorder."""
    nb = int(parent.shape[0])
    if np.any(parent >= np.arange(nb)):
        raise ValueError("the feeder is not in DFS preorder "
                         "(Feeder.reorder_preorder)")
    size = np.ones(nb, np.int64)
    for i in range(nb - 1, -1, -1):
        if parent[i] >= 0:
            size[parent[i]] += size[i]
    tout = np.arange(nb, dtype=np.int64) + size
    # Preorder: the children's intervals tile the parent's.
    for i in range(1, nb):
        p = parent[i]
        if p >= 0 and not (p < i < tout[p] and tout[i] <= tout[p]):
            raise ValueError("the feeder is not in DFS preorder "
                             "(Feeder.reorder_preorder)")
    return tout


def ladder_operands(feeder: Feeder, dtype: torch.dtype,
                    device: torch.device) -> LadderOperands:
    """The kernels' operands of a feeder already in DFS preorder."""
    parent = np.asarray(feeder.parent, np.int64)
    nb = int(parent.shape[0])
    tout = subtree_ends(parent)
    ks = np.nonzero(tout < nb)[0]
    order = ks[np.argsort(tout[ks], kind="stable")]  # by t, then k
    ptr = np.zeros(nb + 1, np.int64)
    np.add.at(ptr, tout[order] + 1, 1)
    ptr = np.cumsum(ptr)

    def real(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    z = np.asarray(feeder.z_pu)
    zt = _cluster_z(z, ladder_plan(nb, dtype))
    return LadderOperands(
        mask=real(feeder.phase_mask), z_re=real(z.real), z_im=real(z.imag),
        root=real((parent < 0).astype(np.float64)), tout=i32(tout),
        grp_ptr=i32(ptr), grp_idx=i32(order), zt=real(zt))


# ---------------------------------------------------------------------------
# L1's launch plan
# ---------------------------------------------------------------------------


#: The cluster route: threads a CTA at most (two branches each) by dtype
#: (a thread's register budget is 65536 / threads), CTAs a lane at most,
#: the shared words a CTA keeps beside its three ``[6, 2 · threads]``
#: buffers (v, the drops, the prefix) and its staged group indices, and
#: the dynamic shared memory a block may take on an H100.
(_THREADS_F64, _THREADS_F32, MAX_CLUSTER, SCRATCH_WORDS,
 SMEM_LIMIT) = build.constants("ladder.cu", "kCtaThreadsF64", "kCtaThreadsF32",
                               "kMaxCluster", "kScratchWords", "kSmemLimit")
CTA_THREADS = {torch.float64: _THREADS_F64, torch.float32: _THREADS_F32}
#: Threads a CTA of the global route (one CTA a lane).
GLOBAL_THREADS = 512
_ITEMSIZE = {torch.float64: 8, torch.float32: 4}


def _cta_smem(threads: int, itemsize: int) -> int:
    """A CTA's buffers [3, 6, 2·threads], its scratch and the staged group
    indices (int32, 2·threads)."""
    return (36 * threads + SCRATCH_WORDS) * itemsize + 8 * threads


def cluster_capacity(dtype: torch.dtype) -> int:
    """The most branches the cluster route takes in ``dtype``: the widest
    CTA whose buffers fit in shared memory, two branches a thread, times
    :data:`MAX_CLUSTER` (float64 20,480, float32 32,768)."""
    item = _itemsize(dtype)
    threads = CTA_THREADS[dtype]
    while _cta_smem(threads, item) > SMEM_LIMIT:
        threads -= 32
    return MAX_CLUSTER * 2 * threads


def _itemsize(dtype: torch.dtype) -> int:
    if dtype not in _ITEMSIZE:
        raise TypeError(f"the ladder kernels take float64 or float32, got "
                        f"{dtype}")
    return _ITEMSIZE[dtype]


class LadderPlan(NamedTuple):
    """L1's launch shape at ``nb`` branches: the ``route`` (``"cluster"``
    or ``"global"``), the CTAs a lane (``cluster``; 1 on the global
    route), the branches a CTA owns (``per``: CTA ``r`` the preorder
    interval ``[r·per, min(nb, (r+1)·per))``, two a thread), its
    ``threads`` and its dynamic shared memory in bytes (``smem``; 0 on the
    global route)."""

    route: str
    cluster: int
    per: int
    threads: int
    smem: int

    def intervals(self, nb: int) -> Tuple[Tuple[int, int], ...]:
        """Each CTA's branch interval ``[lo, hi)``, in rank order."""
        return tuple((r * self.per, min(nb, (r + 1) * self.per))
                     for r in range(self.cluster))


def ladder_plan(nb: int, dtype: torch.dtype) -> LadderPlan:
    """L1's launch plan: a function of the branch count and the dtype
    alone — never of the lane count or the card's free SMs — so that a
    lane gives the same bits in a launch of any width (QSTS rechunking
    and resumes rely on it).  Up to :func:`cluster_capacity` branches a
    lane is the smallest cluster whose CTAs' buffers fit in shared memory
    with the branches split evenly (fewer SMs a lane: more lanes at once;
    at 10k branches 8 CTAs in float64, 5 in float32); above it the global
    route, one CTA a lane."""
    nb = int(nb)
    if nb <= 0:
        raise ValueError(f"ladder_plan needs nb >= 1, got {nb}")
    item = _itemsize(dtype)
    most = CTA_THREADS[dtype]
    for cluster in range(math.ceil(nb / (2 * most)), MAX_CLUSTER + 1):
        per = math.ceil(nb / cluster)
        threads = 32 * math.ceil(per / 64)
        smem = _cta_smem(threads, item)
        if threads <= most and smem <= SMEM_LIMIT and (cluster - 1) * per < nb:
            return LadderPlan("cluster", cluster, per, threads, smem)
    return LadderPlan("global", 1, nb, GLOBAL_THREADS, 0)


def _row_width(plan: LadderPlan) -> int:
    return plan.cluster * 2 * plan.threads if plan.route == "cluster" else 0


def _cluster_z(z: np.ndarray, plan: LadderPlan) -> np.ndarray:
    """z ``[nb, 3, 3]`` complex in the cluster route's row layout ``[2
    (re, im), 9 (entry 3 q + p), cluster · 2 · threads]``: each row holds
    CTA ``r``'s branches at ``r · 2 · threads + (i − r · per)`` (zeros
    elsewhere), so a warp reads a row contiguously; ``[2, 9, 0]`` on the
    global route."""
    nb = z.shape[0]
    out = np.zeros((2, 9, _row_width(plan)))
    if plan.route == "cluster":
        i = np.arange(nb)
        r = i // plan.per
        col = r * 2 * plan.threads + i - r * plan.per
        out[0][:, col] = z.real.reshape(nb, 9).T
        out[1][:, col] = z.imag.reshape(nb, 9).T
    return out


class LadderOut(NamedTuple):
    """L1's results in preorder space: ``v``, ``i_branch``, ``i_load``
    ``[B, nb, 3]`` pairs; ``iterations [B]`` int32, ``converged [B]``
    bool, ``residual [B]``; the saved iterates (fixed mode with
    ``save=True``) or ``None``."""

    v: C
    i_branch: C
    i_load: C
    iterations: Tensor
    converged: Tensor
    residual: Tensor
    saved: Optional[Tensor]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def _pack(x: C) -> Tensor:
    return torch.cat([x.re, x.im], dim=-1)


def _unpack(x: Tensor) -> C:
    return C(x[..., :3], x[..., 3:])


def preorder_sweeps(op: LadderOperands) -> Tuple[Callable, Callable]:
    """L1's two sweeps in PyTorch, in the kernel's formulas: the subtree
    sums ``P[tout_i] − P[i]`` over the exclusive prefix ``P``, and the path
    sums as one inclusive prefix of ``x − q`` with ``q[t]`` the sum of the
    ``x_k`` whose subtree closes at ``t``, added from 0 in increasing
    ``k`` as the kernel adds them (a gather a column of the groups padded
    to the largest, no atomics: the same bits on every run, on the card
    too)."""
    nb = op.nb
    tout = op.tout.long()
    ptr = op.grp_ptr.cpu().numpy().astype(np.int64)
    idx = op.grp_idx.cpu().numpy().astype(np.int64)
    cnt = np.diff(ptr)
    table = np.full((nb, max(int(cnt.max()) if nb else 0, 1)), nb, np.int64)
    table[np.repeat(np.arange(nb), cnt),
          np.arange(idx.shape[0]) - np.repeat(ptr[:-1], cnt)] = idx
    columns = [torch.as_tensor(table[:, j], device=op.tout.device)
               for j in range(table.shape[1])]

    def backward(x: C) -> C:
        a = _pack(x)
        zero = torch.zeros(a.shape[:-2] + (1, 6), dtype=a.dtype,
                           device=a.device)
        ps = torch.cat([zero, torch.cumsum(a, dim=-2)], dim=-2)
        return _unpack(ps[..., tout, :] - ps[..., :nb, :])

    def forward(x: C) -> C:
        a = _pack(x)
        zero = torch.zeros(a.shape[:-2] + (1, 6), dtype=a.dtype,
                           device=a.device)
        padded = torch.cat([a, zero], dim=-2)  # row nb: the empty slot
        q = torch.zeros_like(a)
        for col in columns:
            q = q + padded[..., col, :]
        return _unpack(torch.cumsum(a - q, dim=-2))

    return backward, forward


def ladder_iterate_plain(s: C, v0: C, mask: Tensor, z_re: Tensor,
                         z_im: Tensor, root: Tensor, backward, forward,
                         eps: float, max_iter: int, fixed: bool,
                         save: bool = False) -> LadderOut:
    """The ladder fixed point in PyTorch on any pair of sweeps: ``s [B,
    nb, 3]`` pu, ``v0 [B, 3]``.  ``fixed``: exactly ``max_iter``
    iterations (differentiable by ``torch.autograd``); else the
    reference's vmapped ``while_loop``: every iteration runs on all lanes
    and a lane's state updates while ``it < max_iter`` and ``err >= eps``
    held on it (one host read of the flags an iteration)."""
    lanes = s.re.shape[0]
    dtype, dev = s.re.dtype, s.re.device
    v = C(v0.re[:, None, :] * mask, v0.im[:, None, :] * mask)
    zero = torch.zeros_like(v.re)
    ib, il = C(zero, zero), C(zero, zero)
    it = torch.zeros(lanes, dtype=torch.int32, device=dev)
    err = torch.full((lanes,), float("inf"), dtype=dtype, device=dev)
    saved = []
    for _ in range(max_iter):
        if not fixed:
            active = (it < max_iter) & (err >= eps)
            if not bool(active.any()):
                break
        if save:
            saved.append(_pack(v))
        live = v.abs2() > 0
        i_load = (s / v.where(live, 1.0)).conj().where(live)
        i_branch = backward(i_load)
        drop = einsum("...bq,bqp->...bp", i_branch, C(z_re, z_im))
        v_new = forward(drop)
        v_new = C((v0.re[:, None, :] - v_new.re) * mask,
                  (v0.im[:, None, :] - v_new.im) * mask)
        # The residual is diagnostics: no gradient (|z|'s backward is
        # 0/0 at the zeros dead phases give).
        d = C(i_branch.re.detach() - ib.re.detach(),
              i_branch.im.detach() - ib.im.detach()).abs() * root[:, None]
        e = torch.amax(d.reshape(lanes, -1), dim=1)
        if fixed:
            v, ib, il, err = v_new, i_branch, i_load, e
            it = it + 1
        else:
            a3 = active[:, None, None]
            v = C(torch.where(a3, v_new.re, v.re),
                  torch.where(a3, v_new.im, v.im))
            ib = C(torch.where(a3, i_branch.re, ib.re),
                   torch.where(a3, i_branch.im, ib.im))
            il = C(torch.where(a3, i_load.re, il.re),
                   torch.where(a3, i_load.im, il.im))
            err = torch.where(active, e, err)
            it = it + active.to(torch.int32)
    return LadderOut(v, ib, il, it, err < eps, err,
                     torch.stack(saved) if save and saved else None)


def ladder_solve_plain(s: C, v0: C, op: LadderOperands, eps: float,
                       max_iter: int, fixed: bool,
                       save: bool = False) -> LadderOut:
    """L1's plain version: :func:`ladder_iterate_plain` on
    :func:`preorder_sweeps`."""
    backward, forward = preorder_sweeps(op)
    return ladder_iterate_plain(s, v0, op.mask, op.z_re, op.z_im, op.root,
                                backward, forward, eps, max_iter, fixed, save)


def ladder_vjp_plain(saved: Tensor, s: C, op: LadderOperands, gv: C, gb: C,
                     gl: C) -> C:
    """L2's plain version: the cotangent of ``s`` from those of the
    final ``v`` (``gv``), ``i_branch`` (``gb``) and ``i_load`` (``gl``),
    walking the saved iterates backwards (the module docstring of
    ``csrc/ladder.cu`` gives the recurrence)."""
    backward, forward = preorder_sweeps(op)
    mask = op.mask
    z_re, z_im = op.z_re, op.z_im
    vbar = gv
    sbar = C(torch.zeros_like(s.re), torch.zeros_like(s.im))
    spec = "...bp,bqp->...bq"
    for k in range(saved.shape[0] - 1, -1, -1):
        vk = _unpack(saved[k])
        a = C(vbar.re * mask, vbar.im * mask)
        db = -backward(a)
        ibb = einsum(spec, db, C(z_re, -z_im))  # conj(z)^T dropbar
        if k == saved.shape[0] - 1:
            ibb = ibb + gb
        ilb = forward(ibb)
        if k == saved.shape[0] - 1:
            ilb = ilb + gl
        live = vk.abs2() > 0
        safe = vk.where(live, 1.0)
        sbar = sbar + (ilb / safe).conj().where(live)
        vbar = ((-(s * ilb)) / (safe * safe)).conj().where(live)
    return sbar


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "ladder_solve": [_P] * 25 + [_I] * 4 + [ctypes.c_double] + [_I] * 4
    + [_P],
    "ladder_vjp": [_P] * 20 + [_I] * 3 + [_P],
    "ladder_cluster_check": [_I] * 3 + [_P],
}
_lib_lock = threading.Lock()
_fns: Dict[str, object] = {}


def _fn(name: str):
    """The C entry point ``name`` (``ladder_solve_f64``, ...); the
    library is built and loaded at the first call."""
    fn = _fns.get(name)
    if fn is None:
        with _lib_lock:
            if not _fns:
                lib = build.load("ladder")
                for base, args in _SIGS.items():
                    for sfx in ("f64", "f32"):
                        f = getattr(lib, f"{base}_{sfx}")
                        f.argtypes = args
                        f.restype = _I
                        _fns[f"{base}_{sfx}"] = f
        fn = _fns[name]
    return fn


def _ladder_lib() -> None:
    """Build and load the kernels' library now (it happens at the first
    launch otherwise)."""
    _fn("ladder_solve_f64")


def _suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"the ladder kernels take float64 or float32, got {dtype}")


def _want(dev, dtype, **tensors) -> None:
    """Device, dtype, shape and contiguity of a launch's operands (``None``
    as the dtype: int32)."""
    for name, (t, shape, is_int) in tensors.items():
        want = torch.int32 if is_int else dtype
        if t.device != dev or t.dtype is not want:
            raise ValueError(f"{name} must be {want} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"tensor, got {tuple(t.shape)}")


#: Operand sets already checked (by id, with the set kept alive).
_checked: Dict[int, LadderOperands] = {}


def _check_op(op: LadderOperands, dev, dtype) -> None:
    if _checked.get(id(op)) is op and op.mask.dtype is dtype \
            and op.mask.device == dev:
        return
    nb = op.nb
    _want(dev, dtype, mask=(op.mask, (nb, 3), False),
          z_re=(op.z_re, (nb, 3, 3), False), z_im=(op.z_im, (nb, 3, 3), False),
          root=(op.root, (nb,), False), tout=(op.tout, (nb,), True),
          grp_ptr=(op.grp_ptr, (nb + 1,), True),
          grp_idx=(op.grp_idx, (int(op.grp_idx.shape[0]),), True),
          zt=(op.zt, (2, 9, _row_width(ladder_plan(nb, dtype))), False))
    with _launch_lock:
        if len(_checked) >= 64:
            _checked.clear()
        _checked[id(op)] = op


#: Clusters of a plan's shape the card holds at once, by (device, dtype,
#: plan), from the first launch of that shape on that device.
_resident: Dict[tuple, int] = {}


def resident_clusters(plan: LadderPlan, dtype: torch.dtype,
                      device: torch.device) -> int:
    """How many clusters of ``plan``'s shape the card places at once
    (``cudaOccupancyMaxActiveClusters``); raises, naming the shape, where
    it cannot place one."""
    key = (device.index, dtype, plan)
    got = _resident.get(key)
    if got is None:
        active = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _fn(f"ladder_cluster_check_{_suffix(dtype)}")(
                plan.cluster, plan.threads, plan.smem, ctypes.byref(active))
        _raise_on(rc, "ladder_cluster_check")
        got = int(active.value)
        if got < 1:
            raise RuntimeError(
                f"ladder_solve: the card cannot place a cluster of "
                f"{plan.cluster} CTAs x {plan.threads} threads with "
                f"{plan.smem} bytes of shared memory each")
        with _launch_lock:
            _resident[key] = got
    return got


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _on_card(t: Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{t.device}")
    return True


def ladder_solve(s: C, v0: C, op: LadderOperands, eps: float, max_iter: int,
                 fixed: bool, save: bool = False) -> LadderOut:
    """L1: a whole ladder solve of every lane in one launch — ``s [B,
    nb, 3]`` pu and ``v0 [B, 3]`` contiguous pairs, preorder space — on
    :func:`ladder_plan`'s route."""
    if not _on_card(s.re, "ladder_solve"):
        return ladder_solve_plain(s, v0, op, eps, max_iter, fixed, save)
    dev, dtype = s.re.device, s.re.dtype
    sfx = _suffix(dtype)
    nb = op.nb
    lanes = int(s.re.shape[0])
    if lanes < 1 or max_iter < 0:
        raise ValueError(f"ladder_solve needs lanes >= 1 and max_iter >= 0, "
                         f"got {lanes} and {max_iter}")
    _want(dev, dtype, s_re=(s.re, (lanes, nb, 3), False),
          s_im=(s.im, (lanes, nb, 3), False),
          v0_re=(v0.re, (lanes, 3), False), v0_im=(v0.im, (lanes, 3), False))
    _check_op(op, dev, dtype)
    plan = ladder_plan(nb, dtype)
    cluster = plan.route == "cluster"
    if cluster:
        resident_clusters(plan, dtype, dev)

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)

    out = [empty(lanes, nb, 3) for _ in range(6)]
    iters = empty(lanes, dt=torch.int32)
    resid = empty(lanes)
    conv = empty(lanes, dt=torch.bool)
    saved = empty(max_iter, lanes, nb, 6) if (save and fixed) else None
    # The global route's scratch; the cluster route keeps it on chip but
    # the previous i_br (in its row layout).
    ps = None if cluster else empty(lanes, nb + 1, 6)
    drop = None if cluster else empty(lanes, nb, 6)
    ibp = empty(lanes, 6, _row_width(plan)) if cluster else None
    with torch.cuda.device(dev):
        rc = _fn(f"ladder_solve_{sfx}")(
            s.re.data_ptr(), s.im.data_ptr(), v0.re.data_ptr(),
            v0.im.data_ptr(), op.mask.data_ptr(), op.z_re.data_ptr(),
            op.z_im.data_ptr(), op.root.data_ptr(), op.tout.data_ptr(),
            op.grp_ptr.data_ptr(), op.grp_idx.data_ptr(),
            *(t.data_ptr() for t in out), iters.data_ptr(), resid.data_ptr(),
            conv.data_ptr(), None if saved is None else saved.data_ptr(),
            None if ps is None else ps.data_ptr(),
            None if drop is None else drop.data_ptr(), op.zt.data_ptr(),
            None if ibp is None else ibp.data_ptr(), nb, lanes,
            int(max_iter), int(bool(fixed)), float(eps),
            plan.cluster if cluster else 0, plan.per, plan.threads,
            plan.smem, _stream(s.re))
    _raise_on(rc, "ladder_solve")
    _count("ladder_solve")
    return LadderOut(C(out[0], out[1]), C(out[2], out[3]), C(out[4], out[5]),
                     iters, conv, resid, saved)


def ladder_vjp(saved: Tensor, s: C, op: LadderOperands, gv: C, gb: C,
               gl: C) -> C:
    """L2: the cotangent of ``s [B, nb, 3]`` from the cotangents ``gv``,
    ``gb``, ``gl`` of L1's final ``v``, ``i_branch``, ``i_load`` and its
    saved iterates ``[iters, B, nb, 6]``, in one launch."""
    if not _on_card(s.re, "ladder_vjp"):
        return ladder_vjp_plain(saved, s, op, gv, gb, gl)
    dev, dtype = s.re.device, s.re.dtype
    sfx = _suffix(dtype)
    nb = op.nb
    lanes = int(s.re.shape[0])
    iters = int(saved.shape[0])
    lane3 = (lanes, nb, 3)
    _want(dev, dtype, saved=(saved, (iters, lanes, nb, 6), False),
          s_re=(s.re, lane3, False), s_im=(s.im, lane3, False),
          gv_re=(gv.re, lane3, False), gv_im=(gv.im, lane3, False),
          gb_re=(gb.re, lane3, False), gb_im=(gb.im, lane3, False),
          gl_re=(gl.re, lane3, False), gl_im=(gl.im, lane3, False))
    _check_op(op, dev, dtype)
    sbar = C(torch.empty(lane3, dtype=dtype, device=dev),
             torch.empty(lane3, dtype=dtype, device=dev))
    ps = torch.empty(lanes, nb + 1, 6, dtype=dtype, device=dev)
    w = torch.empty(lanes, nb, 6, dtype=dtype, device=dev)
    g = torch.empty(lanes, nb, 6, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _fn(f"ladder_vjp_{sfx}")(
            saved.data_ptr(), s.re.data_ptr(), s.im.data_ptr(),
            op.mask.data_ptr(), op.z_re.data_ptr(), op.z_im.data_ptr(),
            op.tout.data_ptr(), op.grp_ptr.data_ptr(), op.grp_idx.data_ptr(),
            gv.re.data_ptr(), gv.im.data_ptr(), gb.re.data_ptr(),
            gb.im.data_ptr(), gl.re.data_ptr(), gl.im.data_ptr(),
            sbar.re.data_ptr(), sbar.im.data_ptr(), ps.data_ptr(),
            w.data_ptr(), g.data_ptr(), nb, lanes, iters, _stream(s.re))
    _raise_on(rc, "ladder_vjp")
    _count("ladder_vjp")
    return sbar


class LadderFixed(torch.autograd.Function):
    """The fixed-iteration ladder solve as a differentiable function of
    the loads: forward L1 in fixed mode, saving its iterates; backward
    L2.  ``apply(s_re, s_im, v0_re, v0_im, op, eps, max_iter)`` with the
    loads ``[B, nb, 3]`` (pu, preorder) returns ``(v_re, v_im, ib_re,
    ib_im, il_re, il_im, iterations, converged, residual)``; the source
    phasors get no gradient."""

    @staticmethod
    def forward(ctx, s_re, s_im, v0_re, v0_im, op, eps, max_iter):
        s = C(s_re.contiguous(), s_im.contiguous())
        out = ladder_solve(s, C(v0_re, v0_im), op, eps, max_iter,
                           fixed=True, save=True)
        saved = out.saved
        if saved is None:  # max_iter == 0: no iteration to walk back
            saved = s.re.new_zeros((0,) + tuple(s.re.shape[:-1]) + (6,))
        ctx.save_for_backward(saved, s.re, s.im)
        ctx.op = op
        ctx.mark_non_differentiable(out.iterations, out.converged,
                                    out.residual)
        return (out.v.re, out.v.im, out.i_branch.re, out.i_branch.im,
                out.i_load.re, out.i_load.im, out.iterations, out.converged,
                out.residual)

    @staticmethod
    def backward(ctx, gv_re, gv_im, gb_re, gb_im, gl_re, gl_im, *_):
        saved, s_re, s_im = ctx.saved_tensors

        def c(re, im):
            return C(re.contiguous(), im.contiguous())

        sbar = ladder_vjp(saved, C(s_re, s_im), ctx.op, c(gv_re, gv_im),
                          c(gb_re, gb_im), c(gl_re, gl_im))
        return sbar.re, sbar.im, None, None, None, None, None
