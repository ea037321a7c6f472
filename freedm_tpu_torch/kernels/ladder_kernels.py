"""Wrappers, plain versions and launch counters of the ladder kernels.

================================  ========================================  =====
wrapper                           replaces                                  route
================================  ========================================  =====
:func:`ladder_solve` (L1)         ``freedm_tpu/pf/ladder.py`` ``_solve``     CUDA
                                  (:184) and ``_solve_fixed`` (:209): the
                                  iteration ``_sweep`` (:138) and
                                  ``_root_err`` (:148) on the preorder
                                  ``euler_sweeps`` of ``pf/sweeps.py``
                                  (:124, :204-226)
:func:`ladder_vjp` (L2)           the reverse mode of ``_solve_fixed`` (the  CUDA
                                  ``jax.value_and_grad`` of
                                  ``freedm_tpu/modules/vvc.py:117``) on
                                  L1's sweeps
:func:`ladder_dense` (L3)         ``_solve`` and ``_solve_fixed`` on         CUDA
                                  ``pf/sweeps.py:45`` ``dense_sweeps``,
                                  and their reverse mode
                                  (:func:`ladder_dense_vjp`)
:func:`ladder_doubling` (L4)      the same on ``pf/sweeps.py:60``            CUDA
                                  ``doubling_sweeps``, and their reverse
                                  mode (:func:`ladder_doubling_vjp`)
================================  ========================================  =====

L1, L2 and L4 live in ``csrc/ladder.cu``, L3 in ``csrc/ladder_dense.cu``
(float64 and float32).  A wrapper given CPU tensors runs its plain
PyTorch version; given CUDA tensors it launches its kernel or raises.
Each call that launches adds the kernel launches it issued to
:data:`LAUNCHES` — one, but for L3's tiled route, whose C entry reports
its ``2 + 2 · max_iter`` (solve) and ``2 + 2 · iters`` (reverse mode)
launches — and :data:`MODE_LAUNCHES` splits L3's and L4's between their
forward and reverse modes.  Each kernel takes one of two routes,
chosen from the branch count and dtype alone (so a lane's result is the
same bits whatever the lanes beside it).  L1 and L2 (:func:`ladder_plan`):
from the measured crossover (:data:`CLUSTER_FROM`) up to
:func:`cluster_capacity` branches a lane is
one thread-block cluster whose shared memory holds its state, below and
above that one CTA a lane with its state in device memory (as few warps
as hold the lane's runs of 32 branches, :func:`global_threads`).  L4
(:func:`doubling_plan`): likewise up to :func:`doubling_capacity`, its
rows dealt to the cluster's CTAs in blocks of 32 and its long preimage
lists a warp's (:func:`heavy_rows`).  L3 (:func:`dense_plan`): up to
:func:`dense_cta_capacity` branches one CTA a lane runs a whole solve
with the subtree matrix as bits and the lane's state in shared memory,
in one launch; above that the products run over the subtree matrix's
nonzero 64 × 16 blocks in DFS preorder (:func:`nonzero_blocks`,
:func:`slice_plan`), on the FP64 tensor cores in float64.  A
measurement launches either route of L1, L2 or L4 through the wrappers'
``plan=`` (:func:`route_plan`); no other plan is taken.

L1 and L2 work in DFS preorder (:meth:`Feeder.reorder_preorder`), on
:class:`LadderOperands` made once per feeder; L3 and L4 take and return
the caller's branch order, as the reference's dense and doubling sweeps
do, on :class:`DenseOperands` and :class:`DoublingOperands` (L3's tiled
route permutes inside its kernels).  Lanes are ``[B,
nb, 3]`` :class:`~freedm_tpu_torch.cplx.C` pairs: the loads ``s`` in pu
and the per-lane source phasors ``v0 [B, 3]``.  A solve runs every
iteration of every lane in one call — in ``solve`` mode each lane stops
on its own at ``err < eps`` or ``max_iter``; in ``fixed`` mode every lane
runs ``max_iter`` iterations and, with ``save=True``, keeps each
iteration's input voltages (``[max_iter, B, nb, 6]``, re ‖ im, 8 · 6 · nb
· B · max_iter bytes in float64: 0.6 GB at 10k buses × 64 lanes × 20) for
the reverse mode.  A reverse mode walks those iterates backwards and
returns the cotangents of ``s`` and of ``v0``.  :class:`LadderFixed` is
the ``torch.autograd`` function whose forward is a form's fixed solve and
whose backward is that form's reverse mode; the form follows the
operands.
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
from freedm_tpu_torch.pf import sweeps

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"ladder_solve": 0, "ladder_vjp": 0,
                            "ladder_dense": 0, "ladder_doubling": 0}
#: L3's and L4's launches of :data:`LAUNCHES` by mode: ``forward`` (a
#: solve, fixed or not) and ``reverse``.
MODE_LAUNCHES: Dict[str, Dict[str, int]] = {
    k: {"forward": 0, "reverse": 0} for k in ("ladder_dense",
                                              "ladder_doubling")}
_launch_lock = threading.Lock()


def _count(name: str, n: int = 1, mode: Optional[str] = None) -> None:
    with _launch_lock:
        LAUNCHES[name] += n
        if mode is not None:
            MODE_LAUNCHES[name][mode] += n


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for counts in MODE_LAUNCHES.values():
            for k in counts:
                counts[k] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def mode_launches() -> Dict[str, Dict[str, int]]:
    with _launch_lock:
        return {k: dict(v) for k, v in MODE_LAUNCHES.items()}


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
    zt = _cluster_z(z, _ladder_shape(nb, dtype))
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
#: L4's cluster route: a preimage list longer than ``HEAVY_ROW`` takes a
#: warp (a thread a row at most that), a warp's stage is ``[6,
#: STAGE_LD]`` words, and its scratch words beside the buffers and stages.
HEAVY_ROW, STAGE_LD, DOUBLING_SCRATCH_WORDS = build.constants(
    "ladder.cu", "kHeavyRow", "kStageLd", "kDoublingScratchWords")
#: Threads a CTA of the global route (one CTA a lane) at most.
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


#: The least branch count at which L1, L2 and L4 take their cluster
#: routes (below it one CTA of :func:`global_threads` a lane), measured by
#: ``chip_smoke.time_crossover`` (both routes at nb = 8, 32, …, 2048, f64
#: and f32, × 64 lanes — the served bursts' widest — and × 1536, QSTS's
#: chunk of 24 steps × 64 scenarios; ``PERF.md`` gives the times).  The
#: plan may not depend on the lane count, so it takes the widest width's:
#: on an NVIDIA H100 80GB HBM3 at 700 W the cluster route was the faster
#: from 256 branches at × 1536 for all four kernels in both dtypes (from
#: 32-256 by kernel), while at × 64 one CTA a lane stayed the faster to
#: 511 (f64) and 1023 (f32) branches, up to 1.9× (vvc_9bus, 8 branches:
#: one CTA a lane the faster at both widths, 2.0-6.5×).
CLUSTER_FROM = 256


class LadderPlan(NamedTuple):
    """L1's and L2's launch shape at ``nb`` branches (L4's has the same
    fields): the ``route``
    (``"cluster"`` or ``"global"``), the CTAs a lane (``cluster``; 1 on the
    global route), the branches a CTA owns (``per``: CTA ``r`` the preorder
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


def _cluster_shape(nb: int, dtype: torch.dtype, smem_of) -> Optional[LadderPlan]:
    """The smallest cluster whose CTAs (two branches or rows a thread, at
    most ``CTA_THREADS[dtype]``) fit ``smem_of(threads, itemsize)`` bytes
    of shared memory with the ``nb`` split evenly, or ``None`` above
    :data:`MAX_CLUSTER` CTAs."""
    nb = int(nb)
    if nb <= 0:
        raise ValueError(f"a ladder plan needs nb >= 1, got {nb}")
    item = _itemsize(dtype)
    most = CTA_THREADS[dtype]
    for cluster in range(math.ceil(nb / (2 * most)), MAX_CLUSTER + 1):
        per = math.ceil(nb / cluster)
        threads = 32 * math.ceil(per / 64)
        smem = smem_of(threads, item)
        if threads <= most and smem <= SMEM_LIMIT and (cluster - 1) * per < nb:
            return LadderPlan("cluster", cluster, per, threads, smem)
    return None


def _ladder_shape(nb: int, dtype: torch.dtype) -> Optional[LadderPlan]:
    """L1's and L2's cluster shape, whatever the crossover."""
    return _cluster_shape(nb, dtype, _cta_smem)


def global_threads(rows: int) -> int:
    """The one-CTA routes' width for ``rows`` rows: a warp a run of 32,
    at most :data:`GLOBAL_THREADS`.  L1's and L2's global kernel cuts a
    lane into the runs of 32 branches its 16 warps would take, so fewer
    warps leave out only empty runs (the same bits, as do L4's, whose rows
    are their threads'); narrow CTAs put more lanes on an SM at once (at
    vvc_9bus one warp, not 16)."""
    return 32 * min(GLOBAL_THREADS // 32, max(1, math.ceil(rows / 32)))


def ladder_plan(nb: int, dtype: torch.dtype) -> LadderPlan:
    """L1's and L2's launch plan: a function of the branch count and the
    dtype alone — never of the lane count or the card's free SMs — so that
    a lane gives the same bits in a launch of any width (QSTS rechunking
    and resumes rely on it).  From :data:`CLUSTER_FROM` up to
    :func:`cluster_capacity` branches a lane is the smallest cluster whose
    CTAs' buffers fit in shared memory with the branches split evenly
    (fewer SMs a lane: more lanes at once; at 10k branches 8 CTAs in
    float64, 5 in float32; L2's three buffers hold its vbar and ibbar, the
    loads' cotangent and the prefixes, z in the same layout); below and
    above, the global route, one CTA of :func:`global_threads` a lane."""
    nb = int(nb)
    if nb <= 0:
        raise ValueError(f"ladder_plan needs nb >= 1, got {nb}")
    shape = _ladder_shape(nb, dtype)
    if shape is None or nb < CLUSTER_FROM:
        return route_plan(nb, dtype, "global")
    return shape


def route_plan(nb: int, dtype: torch.dtype, route: str,
               doubling: bool = False) -> LadderPlan:
    """L1's and L2's plan (L4's with ``doubling``) on the named route at
    ``(nb, dtype)``, whatever :data:`CLUSTER_FROM`: ``"cluster"``, or one
    CTA a lane (``"global"``; L4's ``"cta"``).  A wrapper given it
    (``plan=``) launches that route: how ``chip_smoke.time_crossover``
    times and checks both routes of one shape.  Raises above the cluster
    route's capacity."""
    nb = int(nb)
    if nb <= 0:
        raise ValueError(f"route_plan needs nb >= 1, got {nb}")
    one = "cta" if doubling else "global"
    if route == one:
        return LadderPlan(one, 1, nb, global_threads(nb + doubling), 0)
    if route != "cluster":
        raise ValueError(f"no route {route!r}: 'cluster' or {one!r}")
    shape = (_doubling_shape if doubling else _ladder_shape)(nb, dtype)
    if shape is None:
        raise ValueError(f"{nb} branches exceed the cluster route's capacity "
                         f"in {dtype}")
    return shape


def _plan_for(plan: Optional[LadderPlan], nb: int, dtype: torch.dtype,
              doubling: bool) -> LadderPlan:
    """The plan a wrapper launches: its kernel's own (``plan`` None), or
    the caller's, which must be one of the two routes' at ``(nb, dtype)``
    (:func:`route_plan`)."""
    if plan is None:
        return doubling_plan(nb, dtype) if doubling else ladder_plan(nb, dtype)
    if plan.route in ("cluster", "cta" if doubling else "global"):
        try:
            if route_plan(nb, dtype, plan.route, doubling) == plan:
                return plan
        except ValueError:
            pass
    raise ValueError(f"{plan} is no route's plan at {nb} branches in {dtype}")


def _row_width(plan: Optional[LadderPlan]) -> int:
    return plan.cluster * 2 * plan.threads if plan is not None else 0


def _cluster_z(z: np.ndarray, plan: Optional[LadderPlan]) -> np.ndarray:
    """z ``[nb, 3, 3]`` complex in the cluster route's row layout ``[2
    (re, im), 9 (entry 3 q + p), cluster · 2 · threads]``: each row holds
    CTA ``r``'s branches at ``r · 2 · threads + (i − r · per)`` (zeros
    elsewhere), so a warp reads a row contiguously; ``[2, 9, 0]`` above the
    cluster route's capacity."""
    nb = z.shape[0]
    out = np.zeros((2, 9, _row_width(plan)))
    if plan is not None:
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


def _drop_einsum(i_branch: C, z_re: Tensor, z_im: Tensor) -> C:
    return einsum("...bq,bqp->...bp", i_branch, C(z_re, z_im))


def drop_ordered(i_branch: C, z_re: Tensor, z_im: Tensor) -> C:
    """The drops ``Σ_q i_br[q] z[q, p]`` as the reference's four real
    products, each summed over ``q`` in increasing order with every
    product and sum rounded on its own (L4's arithmetic, so that L4 gives
    this version's bits)."""

    def dot(a, z):
        return ((a[..., 0:1] * z[:, 0, :] + a[..., 1:2] * z[:, 1, :])
                + a[..., 2:3] * z[:, 2, :])

    return C(dot(i_branch.re, z_re) - dot(i_branch.im, z_im),
             dot(i_branch.re, z_im) + dot(i_branch.im, z_re))


def ladder_iterate_plain(s: C, v0: C, mask: Tensor, z_re: Tensor,
                         z_im: Tensor, root: Tensor, backward, forward,
                         eps: float, max_iter: int, fixed: bool,
                         save: bool = False, drop=_drop_einsum) -> LadderOut:
    """The ladder fixed point in PyTorch on any pair of sweeps: ``s [B,
    nb, 3]`` pu, ``v0 [B, 3]``.  ``fixed``: exactly ``max_iter``
    iterations (differentiable by ``torch.autograd``); else the
    reference's vmapped ``while_loop``: every iteration runs on all lanes
    and a lane's state updates while ``it < max_iter`` and ``err >= eps``
    held on it (one host read of the flags an iteration).  ``drop(i_br,
    z_re, z_im)`` forms the voltage drops (the reference's einsum)."""
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
        v_new = forward(drop(i_branch, z_re, z_im))
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


def conj_zt(d: C, z_re: Tensor, z_im: Tensor) -> C:
    """``conj(z)ᵀ d``, ``Σ_p conj(z[q, p]) d[p]``, as one complex
    contraction."""
    return einsum("...bp,bqp->...bq", d, C(z_re, -z_im))


def vjp_iterate_plain(saved: Tensor, s: C, mask: Tensor, z_re: Tensor,
                      z_im: Tensor, backward, forward, gv: C, gb: C, gl: C,
                      zt=conj_zt, roots=None) -> Tuple[C, C]:
    """The reverse mode of the fixed ladder solve on any pair of sweeps
    (``forward`` the adjoint of ``backward``): the cotangents of ``s`` and
    of the source phasors ``v0 [B, 3]`` from those of the final ``v``
    (``gv``), ``i_branch`` (``gb``) and ``i_load`` (``gl``), walking the
    saved iterates backwards (the module docstring of ``csrc/ladder.cu``
    gives the recurrence).  ``v0``'s cotangent sums ``mask · vbar`` over
    the branches for every iteration's ``v0 − path`` and for the initial
    iterate ``v0 · mask``: as one sum (``roots`` None), or as the subtree
    sums at the ``roots`` (:func:`root_sum`).  ``zt`` computes ``conj(z)ᵀ
    dropbar`` (:func:`conj_zt`, or L4's :func:`conj_zt_ordered`)."""
    vbar = gv
    sbar = C(torch.zeros_like(s.re), torch.zeros_like(s.im))
    v0bar = C(torch.zeros_like(s.re[:, 0]), torch.zeros_like(s.im[:, 0]))
    last = saved.shape[0] - 1
    for k in range(last, -1, -1):
        vk = _unpack(saved[k])
        a = C(vbar.re * mask, vbar.im * mask)
        sub = backward(a)
        v0bar = v0bar + (a.sum(dim=-2) if roots is None
                         else root_sum(sub, roots))
        ibb = zt(-sub, z_re, z_im)  # conj(z)^T dropbar
        if k == last:
            ibb = ibb + gb
        ilb = forward(ibb)
        if k == last:
            ilb = ilb + gl
        live = vk.abs2() > 0
        safe = vk.where(live, 1.0)
        sbar = sbar + (ilb / safe).conj().where(live)
        vbar = ((-(s * ilb)) / (safe * safe)).conj().where(live)
    a = C(vbar.re * mask, vbar.im * mask)
    v0bar = v0bar + (a.sum(dim=-2) if roots is None
                     else root_sum(backward(a), roots))
    return sbar, v0bar


def ladder_vjp_plain(saved: Tensor, s: C, op: LadderOperands, gv: C, gb: C,
                     gl: C) -> Tuple[C, C]:
    """L2's plain version: :func:`vjp_iterate_plain` on
    :func:`preorder_sweeps`."""
    backward, forward = preorder_sweeps(op)
    return vjp_iterate_plain(saved, s, op.mask, op.z_re, op.z_im, backward,
                             forward, gv, gb, gl)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: The C entry points of each library, ``<base>_f64`` and ``<base>_f32``.
_SIGS = {
    "ladder": {
        "ladder_solve": [_P] * 25 + [_I] * 4 + [_D] + [_I] * 4 + [_P],
        "ladder_vjp": [_P] * 22 + [_I] * 7 + [_P],
        "ladder_cluster_check": [_I] * 4 + [_P],
        "ladder_doubling": [_P] * 24 + [_I] * 5 + [_D] + [_I] * 4 + [_P],
        "ladder_doubling_vjp": [_P] * 23 + [_I] * 9 + [_P],
    },
    "ladder_dense": {
        "ladder_dense_tiled": [_P] * 27 + [_I] * 6 + [_D] + [_P] * 2,
        "ladder_dense_tiled_vjp": [_P] * 25 + [_I] * 5 + [_P] * 2,
        "ladder_dense_cta": [_P] * 19 + [_I] * 4 + [_D] + [_P] * 2,
        "ladder_dense_cta_vjp": [_P] * 17 + [_I] * 3 + [_P] * 2,
    },
}
_lib_lock = threading.Lock()
_fns: Dict[str, object] = {}


def _fn(name: str):
    """The C entry point ``name`` (``ladder_solve_f64``, ...); its library
    is built and loaded at the first call of any of its entries."""
    fn = _fns.get(name)
    if fn is None:
        base = name.rsplit("_", 1)[0]
        (lib_name,) = [k for k, sigs in _SIGS.items() if base in sigs]
        with _lib_lock:
            if name not in _fns:
                lib = build.load(lib_name)
                for entry, args in _SIGS[lib_name].items():
                    for sfx in ("f64", "f32"):
                        f = getattr(lib, f"{entry}_{sfx}")
                        f.argtypes = args
                        f.restype = _I
                        _fns[f"{entry}_{sfx}"] = f
        fn = _fns[name]
    return fn


def _ladder_lib() -> None:
    """Build and load the kernels' libraries now (it happens at the first
    launch otherwise)."""
    _fn("ladder_solve_f64")
    _fn("ladder_dense_cta_f64")


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
          zt=(op.zt, (2, 9, _row_width(_ladder_shape(nb, dtype))), False))
    with _launch_lock:
        if len(_checked) >= 64:
            _checked.clear()
        _checked[id(op)] = op


#: Clusters of a plan's shape the card holds at once, by (device, dtype,
#: plan, kernel), from the first launch of that shape on that device.
_resident: Dict[tuple, int] = {}
#: The cluster kernels' numbers in ``ladder_cluster_check``.
_CLUSTER_KINDS = {"ladder_solve": 0, "ladder_vjp": 1, "ladder_doubling": 2,
                  "ladder_doubling_vjp": 3}


def resident_clusters(plan: LadderPlan, dtype: torch.dtype,
                      device: torch.device,
                      kernel: str = "ladder_solve") -> int:
    """How many clusters of ``plan``'s shape of ``kernel``'s cluster route
    the card places at once (``cudaOccupancyMaxActiveClusters``); raises,
    naming the shape, where it cannot place one."""
    key = (device.index, dtype, plan, kernel)
    got = _resident.get(key)
    if got is None:
        active = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _fn(f"ladder_cluster_check_{_suffix(dtype)}")(
                plan.cluster, plan.threads, plan.smem, _CLUSTER_KINDS[kernel],
                ctypes.byref(active))
        _raise_on(rc, "ladder_cluster_check")
        got = int(active.value)
        if got < 1:
            raise RuntimeError(
                f"{kernel}: the card cannot place a cluster of "
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
                 fixed: bool, save: bool = False,
                 plan: Optional[LadderPlan] = None) -> LadderOut:
    """L1: a whole ladder solve of every lane in one launch — ``s [B,
    nb, 3]`` pu and ``v0 [B, 3]`` contiguous pairs, preorder space — on
    :func:`ladder_plan`'s route (or ``plan``'s, :func:`route_plan`)."""
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
    plan = _plan_for(plan, nb, dtype, False)
    cluster = plan.route == "cluster"
    if cluster:
        resident_clusters(plan, dtype, dev, "ladder_solve")

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
               gl: C, plan: Optional[LadderPlan] = None) -> Tuple[C, C]:
    """L2: the cotangents of ``s [B, nb, 3]`` and of the source phasors
    ``v0 [B, 3]`` from the cotangents ``gv``, ``gb``, ``gl`` of L1's final
    ``v``, ``i_branch``, ``i_load`` and its saved iterates ``[iters, B, nb,
    6]``, in one launch on :func:`ladder_plan`'s route (or ``plan``'s)."""
    if not _on_card(s.re, "ladder_vjp"):
        return ladder_vjp_plain(saved, s, op, gv, gb, gl)
    dev, dtype = s.re.device, s.re.dtype
    sfx = _suffix(dtype)
    nb = op.nb
    lanes = int(s.re.shape[0])
    iters = int(saved.shape[0])
    _want_vjp(dev, dtype, saved, s, gv, gb, gl)
    _check_op(op, dev, dtype)
    plan = _plan_for(plan, nb, dtype, False)
    cluster = plan.route == "cluster"
    if cluster:
        resident_clusters(plan, dtype, dev, "ladder_vjp")
    sbar, v0bar = _vjp_outputs(s)
    # The global route's scratch; the cluster route keeps its state on chip.
    scratch = [None] * 3 if cluster else [
        torch.empty(lanes, nb + k, 6, dtype=dtype, device=dev)
        for k in (1, 0, 0)]
    with torch.cuda.device(dev):
        rc = _fn(f"ladder_vjp_{sfx}")(
            saved.data_ptr(), s.re.data_ptr(), s.im.data_ptr(),
            op.mask.data_ptr(), op.z_re.data_ptr(), op.z_im.data_ptr(),
            op.tout.data_ptr(), op.grp_ptr.data_ptr(), op.grp_idx.data_ptr(),
            gv.re.data_ptr(), gv.im.data_ptr(), gb.re.data_ptr(),
            gb.im.data_ptr(), gl.re.data_ptr(), gl.im.data_ptr(),
            sbar.re.data_ptr(), sbar.im.data_ptr(), v0bar.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch),
            op.zt.data_ptr(), nb, lanes, iters,
            plan.cluster if cluster else 0, plan.per, plan.threads,
            plan.smem, _stream(s.re))
    _raise_on(rc, "ladder_vjp")
    _count("ladder_vjp")
    return sbar, _unpack(v0bar)


def _want_vjp(dev, dtype, saved: Tensor, s: C, gv: C, gb: C, gl: C) -> None:
    lanes, nb = int(s.re.shape[0]), int(s.re.shape[1])
    lane3 = (lanes, nb, 3)
    _want(dev, dtype,
          saved=(saved, (int(saved.shape[0]), lanes, nb, 6), False),
          s_re=(s.re, lane3, False), s_im=(s.im, lane3, False),
          gv_re=(gv.re, lane3, False), gv_im=(gv.im, lane3, False),
          gb_re=(gb.re, lane3, False), gb_im=(gb.im, lane3, False),
          gl_re=(gl.re, lane3, False), gl_im=(gl.im, lane3, False))


def _vjp_outputs(s: C) -> Tuple[C, Tensor]:
    """A reverse mode's outputs: the loads' cotangent pair ``[B, nb, 3]``
    and the source phasors' ``[B, 6]`` (re ‖ im)."""
    kw = dict(dtype=s.re.dtype, device=s.re.device)
    return (C(torch.empty(s.re.shape, **kw), torch.empty(s.re.shape, **kw)),
            torch.empty(int(s.re.shape[0]), 6, **kw))


# ---------------------------------------------------------------------------
# L3 and L4: the dense and doubling sweep forms, in the caller's order
# ---------------------------------------------------------------------------


#: L3's shapes, read from ``csrc/ladder_dense.cu``: a tiled product's
#: threads, lanes and rows, a block's columns, a slice's blocks at most,
#: the CTA route's shared memory at most, a plan row's columns.
(DENSE_TILE_THREADS, DENSE_TILE_LANES, DENSE_BLOCK_ROWS, DENSE_BLOCK_K,
 DENSE_SLICE_BLOCKS, DENSE_CTA_SMEM_CAP, DENSE_PLAN_COLS) = build.constants(
    "ladder_dense.cu", "kTileThreads", "kTileLanes", "kBlockRows", "kBlockK",
    "kSliceBlocks", "kCtaSmemCap", "kPlanCols")
#: The tiled route's sums a thread (2 rows × 2 lanes × 6 columns).
(_TILE_OUT,) = build.constants("ladder_dense.cu", "kOut")


class DensePlan(NamedTuple):
    """L3's route for ``(nb, dtype)``: ``"cta"`` (one CTA a lane, the
    subtree matrix as bits and the lane's state in ``smem`` bytes of
    shared memory) or ``"tiled"`` (products over the nonzero blocks)."""

    route: str
    smem: int


def _dense_cta_smem(nb: int, itemsize: int) -> int:
    """The CTA route's shared memory: S and Sᵀ as rows of 32-bit words,
    four ``[nb, 6]`` buffers (``cta_smem`` in the source)."""
    return 2 * nb * (-(-nb // 32)) * 4 + 24 * nb * itemsize


def dense_plan(nb: int, dtype: torch.dtype) -> DensePlan:
    """L3's route, a function of the branch count and dtype alone: the
    CTA route while its shared memory fits ``DENSE_CTA_SMEM_CAP``, else
    the tiled route."""
    if nb < 1:
        raise ValueError(f"a feeder has at least one branch, got {nb}")
    smem = _dense_cta_smem(nb, _itemsize(dtype))
    return DensePlan("cta" if smem <= DENSE_CTA_SMEM_CAP else "tiled", smem)


def dense_cta_capacity(dtype: torch.dtype) -> int:
    """The most branches L3's CTA route takes (642 in float64, 781 in
    float32)."""
    nb = 1
    while _dense_cta_smem(nb + 1, _itemsize(dtype)) <= DENSE_CTA_SMEM_CAP:
        nb += 1
    return nb


def bit_rows(m: np.ndarray) -> np.ndarray:
    """The rows of a 0/1 matrix ``[nb, nb]`` as bits, ``[nb, ⌈nb / 32⌉]``
    int32: column ``j`` of a row is bit ``j % 32`` of word ``j // 32``."""
    nb = m.shape[0]
    words = -(-nb // 32)
    pad = np.zeros((nb, words * 32), bool)
    pad[:, :nb] = m != 0
    packed = np.packbits(pad, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").view(np.int32)


def nonzero_blocks(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A 0/1 matrix ``[nb, nb]`` cut into blocks of ``DENSE_BLOCK_ROWS`` ×
    ``DENSE_BLOCK_K`` (zero-padded at the ragged edges), the nonzero ones
    alone: ``(ptr [tiles + 1], kb [n], data [n, rows, k])`` — row tile
    ``r``'s blocks are ``ptr[r]:ptr[r + 1]``, their K blocks ``kb`` in
    increasing order, their bytes ``data`` (uint8 0/1)."""
    nb = m.shape[0]
    rows, cols = DENSE_BLOCK_ROWS, DENSE_BLOCK_K
    tiles, kbs = -(-nb // rows), -(-nb // cols)
    pad = np.zeros((tiles * rows, kbs * cols), np.uint8)
    pad[:nb, :nb] = m != 0
    blocks = pad.reshape(tiles, rows, kbs, cols).transpose(0, 2, 1, 3)
    nz = blocks.any(axis=(2, 3))
    t_idx, k_idx = np.nonzero(nz)
    ptr = np.concatenate([[0], np.cumsum(nz.sum(axis=1))]).astype(np.int64)
    return ptr, k_idx.astype(np.int32), np.ascontiguousarray(
        blocks[t_idx, k_idx])


def slice_plan(ptr: np.ndarray) -> Tuple[np.ndarray, int]:
    """The tiled product's work items from the row tiles' block lists
    (``nonzero_blocks``'s ``ptr``): each tile's list cut into ⌈n /
    ``DENSE_SLICE_BLOCKS``⌉ near-equal slices of whole blocks (one, possibly
    empty, at least).  A row ``[tile, first block, blocks, slice, slices,
    slot]``; the slices of a tile of several take consecutive scratch
    slots (``-1`` for a tile of one).  A function of the matrix alone,
    never of the lane count.  Returns the rows and the slots used."""
    rows, slot = [], 0
    for r in range(len(ptr) - 1):
        lo, n = int(ptr[r]), int(ptr[r + 1] - ptr[r])
        ns = max(1, -(-n // DENSE_SLICE_BLOCKS))
        for q in range(ns):
            a, b = q * n // ns, (q + 1) * n // ns
            rows.append((r, lo + a, b - a, q, ns, slot + q if ns > 1 else -1))
        slot += ns if ns > 1 else 0
    return np.asarray(rows, np.int32).reshape(-1, DENSE_PLAN_COLS), slot


class DenseBlocks(NamedTuple):
    """One matrix of L3's tiled route, in preorder: its nonzero blocks
    ``data [n, 64, 16]`` (uint8), their K blocks ``kb [n]`` and the slice
    plan ``plan [items, 6]`` (int32), and the scratch slots the plan
    uses."""

    data: Tensor
    kb: Tensor
    plan: Tensor
    slots: int


class DenseOperands(NamedTuple):
    """A feeder's tree for L3, in the caller's branch order: the phase
    ``mask [nb, 3]``, the impedances ``z_re``, ``z_im [nb, 3, 3]`` and
    ``root [nb]`` in the working dtype; the subtree matrix ``sub [nb,
    nb]`` (uint8 0/1: ``sub[i, j] = 1`` iff branch ``j`` lies in branch
    ``i``'s subtree, ``Feeder.subtree``) and its transpose ``sub_t`` (the
    plain version's); the tables of the route :func:`dense_plan` picks —
    the CTA route's ``bits`` and ``bits_t`` (:func:`bit_rows` of ``sub``
    and ``sub_t``), the tiled route's DFS preorder ``order [nb]`` (int32,
    preorder row → caller's branch), ``pmask``, ``pz_re``, ``pz_im`` and
    ``proot`` in preorder, and the nonzero blocks and slice plans of
    ``sub`` and ``sub_t`` in preorder (``s_blocks``, ``t_blocks``); the
    other route's are ``None``."""

    mask: Tensor
    z_re: Tensor
    z_im: Tensor
    root: Tensor
    sub: Tensor
    sub_t: Tensor
    bits: Optional[Tensor]
    bits_t: Optional[Tensor]
    order: Optional[Tensor]
    pmask: Optional[Tensor]
    pz_re: Optional[Tensor]
    pz_im: Optional[Tensor]
    proot: Optional[Tensor]
    s_blocks: Optional[DenseBlocks]
    t_blocks: Optional[DenseBlocks]

    @property
    def nb(self) -> int:
        return int(self.mask.shape[0])


class DoublingOperands(NamedTuple):
    """A feeder's tree for L4, in the caller's branch order: ``mask``,
    ``z_re``, ``z_im``, ``root`` as :class:`DenseOperands`; each round's
    jump table ``jump [rounds, nb + 1]`` (int32: round ``m``'s
    ``2^m``-th ancestor, the roots' and the sentinel's the sentinel slot
    ``nb``) and its preimage lists, the CSR ``pre_ptr [rounds, nb + 1]``
    (absolute offsets) into ``pre_idx`` of ``{i < nb : jump_m[i] = a}``
    for each ``a < nb`` in increasing ``i``; the cluster route's heavy
    rows (:func:`heavy_rows`: ``heavy_ptr [rounds, cluster, warps + 1]``
    into ``heavy_idx``; ``[rounds, 1, 1]`` and empty above its capacity);
    the ``roots`` (int32, increasing), whose subtree sums add to the
    source phasors' cotangent."""

    mask: Tensor
    z_re: Tensor
    z_im: Tensor
    root: Tensor
    jump: Tensor
    pre_ptr: Tensor
    pre_idx: Tensor
    heavy_ptr: Tensor
    heavy_idx: Tensor
    roots: Tensor

    @property
    def nb(self) -> int:
        return int(self.mask.shape[0])

    @property
    def rounds(self) -> int:
        return int(self.jump.shape[0])


def _doubling_smem(threads: int, itemsize: int) -> int:
    """L4's cluster CTA: three ``[6, 2 · threads]`` buffers (two round
    buffers, the thread-private rows), a ``[6, STAGE_LD]`` stage a warp
    and the scratch (``doubling_words`` in the source)."""
    return (36 * threads + (threads // 32) * 6 * STAGE_LD
            + DOUBLING_SCRATCH_WORDS) * itemsize


def _doubling_shape(nb: int, dtype: torch.dtype) -> Optional[LadderPlan]:
    """L4's cluster shape, whatever the crossover (``None`` above its
    capacity)."""
    return _cluster_shape(nb, dtype, _doubling_smem)


def doubling_plan(nb: int, dtype: torch.dtype) -> LadderPlan:
    """L4's launch plan (its solve and its reverse mode), a function of
    the branch count and the dtype alone: the rows ``0..nb − 1`` dealt
    over the smallest cluster whose CTAs hold their ``per = ⌈nb /
    cluster⌉`` rows' two round buffers and third buffer in shared memory,
    two rows a thread — the rows dealt to the CTAs in blocks of 32
    (:func:`doubling_rows`) — (at 10k branches 8 CTAs of 640 threads in
    float64, 5 of 1024 in float32), from :data:`CLUSTER_FROM` up to
    :func:`doubling_capacity` branches; below and above, the one-CTA route
    (``"cta"``, :func:`global_threads` of the ``nb + 1`` rows)."""
    nb = int(nb)
    if nb <= 0:
        raise ValueError(f"doubling_plan needs nb >= 1, got {nb}")
    shape = _doubling_shape(nb, dtype)
    if shape is None or nb < CLUSTER_FROM:
        return route_plan(nb, dtype, "cta", doubling=True)
    return shape


def doubling_capacity(dtype: torch.dtype) -> int:
    """The most branches L4's cluster route takes (float64 20,480, float32
    32,768)."""
    item = _itemsize(dtype)
    threads = CTA_THREADS[dtype]
    while _doubling_smem(threads, item) > SMEM_LIMIT:
        threads -= 32
    return MAX_CLUSTER * 2 * threads


def doubling_rows(nb: int, plan: LadderPlan, rank: int) -> np.ndarray:
    """The rows CTA ``rank`` of L4's cluster route owns: the rows are dealt
    in blocks of 32, block ``k`` to CTA ``k % cluster`` — a warp's lanes
    hold 32 consecutive rows, and a feeder's top rows (the longest
    preimage lists, the ancestors the late path rounds read) spread over
    every CTA — at most ``32 ⌈nb / 32 cluster⌉ ≤ 2 · threads`` a CTA."""
    a = np.arange(nb)
    return a[(a // 32) % plan.cluster == rank]


def heavy_rows(pre_ptr: np.ndarray, plan: LadderPlan
               ) -> Tuple[np.ndarray, np.ndarray]:
    """L4's cluster route's work plan of the long preimage lists: for each
    round and CTA, its rows (:func:`doubling_rows`) whose list holds more
    than ``HEAVY_ROW``
    preimages (the rest are their threads'), each given to one warp of
    the CTA — longest first, to the warp with the least work so far (a
    batch of 32 loads counted as 64 adds) — as ``(ptr [rounds, cluster,
    warps + 1], idx)``: CTA ``r``'s warp ``w`` takes the rows
    ``idx[ptr[m, r, w]:ptr[m, r, w + 1]]`` in round ``m``.  A function of
    the tree and of the plan (so of ``(nb, dtype)``), never of the lane
    count."""
    pre_ptr = np.asarray(pre_ptr, np.int64)
    rounds, nb = pre_ptr.shape[0], pre_ptr.shape[1] - 1
    lens = np.diff(pre_ptr, axis=1)
    warps = plan.threads // 32
    ptr = np.zeros((rounds, plan.cluster, warps + 1), np.int64)
    idx = []
    for m in range(rounds):
        for r in range(plan.cluster):
            own = doubling_rows(nb, plan, r)
            rows = own[lens[m, own] > HEAVY_ROW]
            order = rows[np.argsort(-lens[m, rows], kind="stable")]
            load = np.zeros(warps)
            lists = [[] for _ in range(warps)]
            for a in order:
                w = int(np.argmin(load))
                lists[w].append(int(a))
                load[w] += lens[m, a] + 64 * -(-lens[m, a] // 32)
            for w in range(warps):
                ptr[m, r, w] = len(idx)
                idx.extend(lists[w])
            ptr[m, r, warps] = len(idx)
    return ptr, np.asarray(idx, np.int64)


def _tree_tensors(feeder: Feeder, dtype, device):
    def real(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    z = np.asarray(feeder.z_pu)
    return (real(feeder.phase_mask), real(z.real), real(z.imag),
            real((np.asarray(feeder.parent) < 0).astype(np.float64)))


def dense_operands(feeder: Feeder, dtype: torch.dtype,
                   device: torch.device) -> DenseOperands:
    """L3's operands of a feeder that compiled its subtree matrix, with
    the tables of its route (:func:`dense_plan`), made once on the
    host."""
    if feeder.subtree is None:
        raise ValueError("feeder compiled without a dense subtree matrix")
    sub = np.asarray(feeder.subtree) != 0

    def tensor(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=device)

    tree = _tree_tensors(feeder, dtype, device)
    bits = bits_t = order = s_blocks = t_blocks = None
    pre = (None,) * 4
    if dense_plan(feeder.n_branches, dtype).route == "cta":
        bits, bits_t = tensor(bit_rows(sub)), tensor(bit_rows(sub.T))
    else:
        _, perm = feeder.reorder_preorder()
        sub_pre = sub[np.ix_(perm, perm)]

        def blocks(m):
            ptr, kb, data = nonzero_blocks(m)
            plan, slots = slice_plan(ptr)
            return DenseBlocks(tensor(data), tensor(kb, np.int32),
                               tensor(plan, np.int32), slots)

        order = tensor(perm, np.int32)
        s_blocks, t_blocks = blocks(sub_pre), blocks(sub_pre.T)
        index = torch.as_tensor(perm, dtype=torch.int64, device=device)
        pre = tuple(t[index].contiguous() for t in tree)
    return DenseOperands(*tree, sub=tensor(sub, np.uint8),
                         sub_t=tensor(sub.T, np.uint8), bits=bits,
                         bits_t=bits_t, order=order, pmask=pre[0],
                         pz_re=pre[1], pz_im=pre[2], proot=pre[3],
                         s_blocks=s_blocks, t_blocks=t_blocks)


def doubling_operands(feeder: Feeder, dtype: torch.dtype,
                      device: torch.device) -> DoublingOperands:
    """L4's operands of a feeder: the jump tables, preimage lists, heavy
    rows' plan (of the cluster shape in ``dtype``) and roots, made once on
    the host."""
    parent = np.asarray(feeder.parent)
    jumps = sweeps.doubling_jumps(parent, feeder.levels)
    ptr, idx = sweeps.preimage_lists(jumps)
    shape = _doubling_shape(feeder.n_branches, dtype)
    if shape is None:
        hptr, hidx = np.zeros((jumps.shape[0], 1, 1)), np.zeros(0)
    else:
        hptr, hidx = heavy_rows(ptr, shape)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    return DoublingOperands(*_tree_tensors(feeder, dtype, device),
                            jump=i32(jumps), pre_ptr=i32(ptr),
                            pre_idx=i32(idx), heavy_ptr=i32(hptr),
                            heavy_idx=i32(hidx),
                            roots=i32(np.nonzero(parent < 0)[0]))


def form_sweeps(op) -> Tuple[Callable, Callable]:
    """The plain sweeps of L3's or L4's operands, from
    :mod:`freedm_tpu_torch.pf.sweeps` (the one plain implementation of
    each form): products with the subtree matrix, or the doubling rounds
    on the operands' jump tables and preimage lists (whose gather-sum adds
    in the kernel's order: no atomics, the same bits on the card as on
    the CPU)."""
    if isinstance(op, DenseOperands):
        return sweeps.subtree_sweeps(op.sub.to(op.mask.dtype))

    def host(t):
        return t.cpu().numpy().astype(np.int64)

    return sweeps.jump_sweeps(host(op.jump), host(op.pre_ptr),
                              host(op.pre_idx), device=op.jump.device)


def ladder_dense_plain(s: C, v0: C, op: DenseOperands, eps: float,
                       max_iter: int, fixed: bool,
                       save: bool = False) -> LadderOut:
    """L3's plain version: :func:`ladder_iterate_plain` on
    :func:`form_sweeps` (differentiable by ``torch.autograd`` in fixed
    mode)."""
    backward, forward = form_sweeps(op)
    return ladder_iterate_plain(s, v0, op.mask, op.z_re, op.z_im, op.root,
                                backward, forward, eps, max_iter, fixed, save)


def ladder_doubling_plain(s: C, v0: C, op: DoublingOperands, eps: float,
                          max_iter: int, fixed: bool,
                          save: bool = False) -> LadderOut:
    """L4's plain version: :func:`ladder_iterate_plain` on
    :func:`form_sweeps` with :func:`drop_ordered`."""
    backward, forward = form_sweeps(op)
    return ladder_iterate_plain(s, v0, op.mask, op.z_re, op.z_im, op.root,
                                backward, forward, eps, max_iter, fixed, save,
                                drop=drop_ordered)


def ladder_dense_vjp_plain(saved: Tensor, s: C, op: DenseOperands, gv: C,
                           gb: C, gl: C) -> Tuple[C, C]:
    """L3's reverse mode in PyTorch: :func:`vjp_iterate_plain` on
    :func:`form_sweeps`."""
    backward, forward = form_sweeps(op)
    return vjp_iterate_plain(saved, s, op.mask, op.z_re, op.z_im, backward,
                             forward, gv, gb, gl)


def conj_zt_ordered(d: C, z_re: Tensor, z_im: Tensor) -> C:
    """``conj(z)ᵀ d``, ``Σ_p conj(z[q, p]) d[p]``, as four real products,
    each summed over ``p`` in increasing order with every product and sum
    rounded on its own (L4's reverse mode's arithmetic)."""

    def dot(a, z):
        return ((a[..., 0:1] * z[:, :, 0] + a[..., 1:2] * z[:, :, 1])
                + a[..., 2:3] * z[:, :, 2])

    return C(dot(d.re, z_re) + dot(d.im, z_im),
             dot(d.im, z_re) - dot(d.re, z_im))


def root_sum(x: C, roots) -> C:
    """``x``'s rows at the ``roots`` ``[B, nb, 3] → [B, 3]``, added from 0
    in the roots' order: the total of every branch when ``x`` holds
    subtree sums."""
    re = torch.zeros_like(x.re[..., 0, :])
    im = torch.zeros_like(x.im[..., 0, :])
    for r in roots:
        re = re + x.re[..., r, :]
        im = im + x.im[..., r, :]
    return C(re, im)


def ladder_doubling_vjp_plain(saved: Tensor, s: C, op: DoublingOperands,
                              gv: C, gb: C, gl: C) -> Tuple[C, C]:
    """L4's reverse mode in PyTorch: :func:`vjp_iterate_plain` on
    :func:`form_sweeps` in the kernels' order — ``conj(z)ᵀ`` by
    :func:`conj_zt_ordered`, and ``v0``'s cotangent as the subtree sums at
    the roots — so that L4 gives this version's bits."""
    backward, forward = form_sweeps(op)
    return vjp_iterate_plain(saved, s, op.mask, op.z_re, op.z_im, backward,
                             forward, gv, gb, gl, zt=conj_zt_ordered,
                             roots=op.roots.cpu().tolist())


def _check_form_op(op, dev, dtype) -> None:
    """Device, dtype and shapes of L3's or L4's operands, once a set."""
    if _checked.get(id(op)) is op and op.mask.dtype is dtype \
            and op.mask.device == dev:
        return
    nb = op.nb
    _want(dev, dtype, mask=(op.mask, (nb, 3), False),
          z_re=(op.z_re, (nb, 3, 3), False), z_im=(op.z_im, (nb, 3, 3), False),
          root=(op.root, (nb,), False))
    if isinstance(op, DenseOperands):
        _check_dense_tables(op, dev, dtype)
    else:
        r = op.rounds
        shape = _doubling_shape(nb, dtype)
        hshape = ((r, 1, 1) if shape is None
                  else (r, shape.cluster, shape.threads // 32 + 1))
        _want(dev, None, jump=(op.jump, (r, nb + 1), True),
              pre_ptr=(op.pre_ptr, (r, nb + 1), True),
              pre_idx=(op.pre_idx, (int(op.pre_idx.shape[0]),), True),
              heavy_ptr=(op.heavy_ptr, hshape, True),
              heavy_idx=(op.heavy_idx, (int(op.heavy_idx.shape[0]),), True),
              roots=(op.roots, (int(op.roots.shape[0]),), True))
        if int(op.roots.shape[0]) < 1:
            raise ValueError("a feeder has at least one root")
    with _launch_lock:
        if len(_checked) >= 64:
            _checked.clear()
        _checked[id(op)] = op


def _want_bytes(dev, name: str, t: Tensor, shape) -> None:
    if t.device != dev or t.dtype is not torch.uint8 or tuple(
            t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous uint8 {tuple(shape)} "
                         f"tensor on {dev}")


def _check_dense_tables(op: DenseOperands, dev, dtype) -> None:
    """L3's subtree matrices and the tables of its route."""
    nb = op.nb
    for name, t in (("sub", op.sub), ("sub_t", op.sub_t)):
        _want_bytes(dev, name, t, (nb, nb))
    if dense_plan(nb, dtype).route == "cta":
        words = -(-nb // 32)
        _want(dev, None, bits=(op.bits, (nb, words), True),
              bits_t=(op.bits_t, (nb, words), True))
        return
    _want(dev, None, order=(op.order, (nb,), True))
    _want(dev, dtype, pmask=(op.pmask, (nb, 3), False),
          pz_re=(op.pz_re, (nb, 3, 3), False),
          pz_im=(op.pz_im, (nb, 3, 3), False), proot=(op.proot, (nb,), False))
    tiles = -(-nb // DENSE_BLOCK_ROWS)
    for name, m in (("s_blocks", op.s_blocks), ("t_blocks", op.t_blocks)):
        n, items = int(m.kb.shape[0]), int(m.plan.shape[0])
        _want_bytes(dev, f"{name}.data", m.data,
                    (n, DENSE_BLOCK_ROWS, DENSE_BLOCK_K))
        _want(dev, None, **{f"{name}.kb": (m.kb, (n,), True),
                            f"{name}.plan": (m.plan, (items,
                                                      DENSE_PLAN_COLS), True)})
        if items < tiles:
            raise ValueError(f"{name}.plan covers {items} items for {tiles} "
                             f"row tiles")


def _want_solve(s: C, v0: C, op, max_iter: int, name: str):
    dev, dtype = s.re.device, s.re.dtype
    lanes = int(s.re.shape[0])
    if lanes < 1 or max_iter < 0:
        raise ValueError(f"{name} needs lanes >= 1 and max_iter >= 0, got "
                         f"{lanes} and {max_iter}")
    nb = op.nb
    _want(dev, dtype, s_re=(s.re, (lanes, nb, 3), False),
          s_im=(s.im, (lanes, nb, 3), False),
          v0_re=(v0.re, (lanes, 3), False), v0_im=(v0.im, (lanes, 3), False))
    _check_form_op(op, dev, dtype)
    return dev, dtype, lanes


def _dense_scratch(op: DenseOperands, lanes: int, dtype, dev):
    """The tiled route's scratch: its preorder state ``[6, B, nb, 6]`` (the
    loads, the two products' right-hand sides and three more lane
    states), the slices' sums (the larger plan's slots) and the tiles'
    tickets (cleared by the route's first launch)."""
    lane_tiles = -(-lanes // DENSE_TILE_LANES)
    if lane_tiles > 65535:
        raise ValueError(f"ladder_dense takes at most "
                         f"{DENSE_TILE_LANES * 65535} lanes, got {lanes}")
    nb = op.nb
    slots = max(op.s_blocks.slots, op.t_blocks.slots, 1)
    kw = dict(dtype=dtype, device=dev)
    return (torch.empty(6, lanes, nb, 6, **kw),
            torch.empty(slots * lane_tiles * _TILE_OUT * DENSE_TILE_THREADS,
                        **kw),
            torch.empty(-(-nb // DENSE_BLOCK_ROWS) * lane_tiles,
                        dtype=torch.int32, device=dev))


def _blocks_args(op: DenseOperands):
    s, t = op.s_blocks, op.t_blocks
    return (s.data.data_ptr(), s.kb.data_ptr(), s.plan.data_ptr(),
            t.data.data_ptr(), t.kb.data_ptr(), t.plan.data_ptr(),
            op.order.data_ptr(), op.pmask.data_ptr(), op.pz_re.data_ptr(),
            op.pz_im.data_ptr())


def _items(op: DenseOperands):
    return int(op.s_blocks.plan.shape[0]), int(op.t_blocks.plan.shape[0])


def ladder_dense(s: C, v0: C, op: DenseOperands, eps: float, max_iter: int,
                 fixed: bool, save: bool = False) -> LadderOut:
    """L3: a whole ladder solve of every lane on the dense sweeps — ``s [B,
    nb, 3]`` pu and ``v0 [B, 3]`` contiguous pairs in the caller's branch
    order — issued without a host read, on the route of
    :func:`dense_plan`: one launch, a CTA a lane (``"cta"``), or ``2 + 2 ·
    max_iter`` launches (``"tiled"``): an initial state, then per
    iteration the product with the subtree matrix over its nonzero blocks
    in preorder (the drops, the root error, ``i_load`` and the saved
    iterate in its epilogue) and the product with its transpose (the new
    voltages and the next iteration's loads' currents in its epilogue),
    and the outputs out of preorder.
    A lane that has stopped is frozen, as the reference's vmapped
    ``while_loop`` leaves it."""
    if not _on_card(s.re, "ladder_dense"):
        return ladder_dense_plain(s, v0, op, eps, max_iter, fixed, save)
    dev, dtype, lanes = _want_solve(s, v0, op, max_iter, "ladder_dense")
    nb = op.nb

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)

    out = [empty(lanes, nb, 3) for _ in range(6)]
    saved = empty(max_iter, lanes, nb, 6) if (save and fixed) else None
    it = empty(3, lanes, dt=torch.int32)
    err = empty(3, lanes)
    launched = ctypes.c_int(0)
    sv = None if saved is None else saved.data_ptr()
    tail = (it.data_ptr(), err.data_ptr())
    with torch.cuda.device(dev):
        lane_args = (s.re.data_ptr(), s.im.data_ptr(), v0.re.data_ptr(),
                     v0.im.data_ptr(), *(t.data_ptr() for t in out))
        if dense_plan(nb, dtype).route == "cta":
            rc = _fn(f"ladder_dense_cta_{_suffix(dtype)}")(
                op.bits.data_ptr(), op.bits_t.data_ptr(), op.mask.data_ptr(),
                op.z_re.data_ptr(), op.z_im.data_ptr(), op.root.data_ptr(),
                *lane_args, sv, *tail, nb, lanes, int(max_iter),
                int(bool(fixed)), float(eps), ctypes.byref(launched),
                _stream(s.re))
        else:
            work, part, ticket = _dense_scratch(op, lanes, dtype, dev)
            rc = _fn(f"ladder_dense_tiled_{_suffix(dtype)}")(
                *_blocks_args(op), op.proot.data_ptr(), *lane_args,
                work.data_ptr(), sv, *tail, part.data_ptr(),
                ticket.data_ptr(), *_items(op), nb, lanes, int(max_iter),
                int(bool(fixed)), float(eps), ctypes.byref(launched),
                _stream(s.re))
    _count("ladder_dense", launched.value, "forward")
    _raise_on(rc, "ladder_dense")
    slot = int(max_iter) % 3
    resid = err[slot]
    return LadderOut(C(out[0], out[1]), C(out[2], out[3]), C(out[4], out[5]),
                     it[slot], resid < eps, resid, saved)


def ladder_dense_vjp(saved: Tensor, s: C, op: DenseOperands, gv: C, gb: C,
                     gl: C) -> Tuple[C, C]:
    """L3's reverse mode: the cotangents of ``s`` and ``v0`` (as
    :func:`ladder_vjp`) on the dense sweeps, on the route of
    :func:`dense_plan`: one launch, a CTA a lane, or ``2 + 2 · iters``
    launches: the initial state, per iteration the product with the
    subtree matrix (``−S(mask vbar)``, ``conj(z)ᵀ`` in its epilogue) and
    with its transpose (the loads' and the voltages' cotangents in its
    epilogue), and the loads' cotangent out of preorder with the source
    phasors' summed a lane."""
    if not _on_card(s.re, "ladder_dense_vjp"):
        return ladder_dense_vjp_plain(saved, s, op, gv, gb, gl)
    dev, dtype = s.re.device, s.re.dtype
    _want_vjp(dev, dtype, saved, s, gv, gb, gl)
    _check_form_op(op, dev, dtype)
    lanes, nb, iters = int(s.re.shape[0]), op.nb, int(saved.shape[0])
    sbar, v0bar = _vjp_outputs(s)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        lane_args = (saved.data_ptr(), s.re.data_ptr(), s.im.data_ptr(),
                     gv.re.data_ptr(), gv.im.data_ptr(), gb.re.data_ptr(),
                     gb.im.data_ptr(), gl.re.data_ptr(), gl.im.data_ptr(),
                     sbar.re.data_ptr(), sbar.im.data_ptr(), v0bar.data_ptr())
        if dense_plan(nb, dtype).route == "cta":
            rc = _fn(f"ladder_dense_cta_vjp_{_suffix(dtype)}")(
                op.bits.data_ptr(), op.bits_t.data_ptr(), op.mask.data_ptr(),
                op.z_re.data_ptr(), op.z_im.data_ptr(), *lane_args, nb, lanes,
                iters, ctypes.byref(launched), _stream(s.re))
        else:
            work, part, ticket = _dense_scratch(op, lanes, dtype, dev)
            rc = _fn(f"ladder_dense_tiled_vjp_{_suffix(dtype)}")(
                *_blocks_args(op), *lane_args, work.data_ptr(),
                part.data_ptr(), ticket.data_ptr(), *_items(op), nb, lanes,
                iters, ctypes.byref(launched), _stream(s.re))
    _count("ladder_dense", launched.value, "reverse")
    _raise_on(rc, "ladder_dense_vjp")
    return sbar, _unpack(v0bar)


def _doubling_route(op: DoublingOperands, dtype, dev, kernel: str,
                    plan: Optional[LadderPlan]):
    """L4's plan (its own, or the caller's) and its launch arguments
    (cluster, per, threads, smem; cluster 0 for the one-CTA route)."""
    plan = _plan_for(plan, op.nb, dtype, True)
    if plan.route != "cluster":
        return plan, (0, plan.per, plan.threads, 0)
    resident_clusters(plan, dtype, dev, kernel)
    return plan, (plan.cluster, plan.per, plan.threads, plan.smem)


def ladder_doubling(s: C, v0: C, op: DoublingOperands, eps: float,
                    max_iter: int, fixed: bool, save: bool = False,
                    plan: Optional[LadderPlan] = None) -> LadderOut:
    """L4: a whole ladder solve of every lane on the doubling sweeps in
    one launch — ``s [B, nb, 3]`` pu and ``v0 [B, 3]`` contiguous pairs in
    the caller's branch order — on :func:`doubling_plan`'s route (or
    ``plan``'s, :func:`route_plan`): a lane a thread-block cluster whose
    shared memory holds its rows, or one CTA a lane with its state in
    device memory."""
    if not _on_card(s.re, "ladder_doubling"):
        return ladder_doubling_plain(s, v0, op, eps, max_iter, fixed, save)
    dev, dtype, lanes = _want_solve(s, v0, op, max_iter, "ladder_doubling")
    nb = op.nb
    plan, shape = _doubling_route(op, dtype, dev, "ladder_doubling", plan)

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)

    out = [empty(lanes, nb, 3) for _ in range(6)]
    iters = empty(lanes, dt=torch.int32)
    resid = empty(lanes)
    conv = empty(lanes, dt=torch.bool)
    saved = empty(max_iter, lanes, nb, 6) if (save and fixed) else None
    buf = None if plan.route == "cluster" else empty(lanes, 2, nb + 1, 6)
    with torch.cuda.device(dev):
        rc = _fn(f"ladder_doubling_{_suffix(dtype)}")(
            op.mask.data_ptr(), op.z_re.data_ptr(), op.z_im.data_ptr(),
            op.root.data_ptr(), op.jump.data_ptr(), op.pre_ptr.data_ptr(),
            op.pre_idx.data_ptr(), op.heavy_ptr.data_ptr(),
            op.heavy_idx.data_ptr(), s.re.data_ptr(), s.im.data_ptr(),
            v0.re.data_ptr(), v0.im.data_ptr(),
            *(t.data_ptr() for t in out), iters.data_ptr(), resid.data_ptr(),
            conv.data_ptr(), None if saved is None else saved.data_ptr(),
            None if buf is None else buf.data_ptr(), nb, op.rounds, lanes,
            int(max_iter), int(bool(fixed)), float(eps), *shape,
            _stream(s.re))
    _raise_on(rc, "ladder_doubling")
    _count("ladder_doubling", mode="forward")
    return LadderOut(C(out[0], out[1]), C(out[2], out[3]), C(out[4], out[5]),
                     iters, conv, resid, saved)


def ladder_doubling_vjp(saved: Tensor, s: C, op: DoublingOperands, gv: C,
                        gb: C, gl: C,
                        plan: Optional[LadderPlan] = None) -> Tuple[C, C]:
    """L4's reverse mode: the cotangents of ``s`` and ``v0`` (as
    :func:`ladder_vjp`) on the doubling sweeps in one launch, on
    :func:`doubling_plan`'s route (or ``plan``'s); its plain version's
    bits."""
    if not _on_card(s.re, "ladder_doubling_vjp"):
        return ladder_doubling_vjp_plain(saved, s, op, gv, gb, gl)
    dev, dtype = s.re.device, s.re.dtype
    _want_vjp(dev, dtype, saved, s, gv, gb, gl)
    _check_form_op(op, dev, dtype)
    lanes, nb, iters = int(s.re.shape[0]), op.nb, int(saved.shape[0])
    plan, shape = _doubling_route(op, dtype, dev, "ladder_doubling_vjp",
                                  plan)
    sbar, v0bar = _vjp_outputs(s)
    scratch = [None, None] if plan.route == "cluster" else [
        torch.empty(lanes, 2, nb + 1, 6, dtype=dtype, device=dev),
        torch.empty(lanes, nb, 6, dtype=dtype, device=dev)]
    with torch.cuda.device(dev):
        rc = _fn(f"ladder_doubling_vjp_{_suffix(dtype)}")(
            op.mask.data_ptr(), op.z_re.data_ptr(), op.z_im.data_ptr(),
            op.jump.data_ptr(), op.pre_ptr.data_ptr(), op.pre_idx.data_ptr(),
            op.heavy_ptr.data_ptr(), op.heavy_idx.data_ptr(),
            op.roots.data_ptr(), saved.data_ptr(), s.re.data_ptr(),
            s.im.data_ptr(), gv.re.data_ptr(), gv.im.data_ptr(),
            gb.re.data_ptr(), gb.im.data_ptr(), gl.re.data_ptr(),
            gl.im.data_ptr(), sbar.re.data_ptr(), sbar.im.data_ptr(),
            v0bar.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch), nb,
            op.rounds, int(op.roots.shape[0]), lanes, iters, *shape,
            _stream(s.re))
    _raise_on(rc, "ladder_doubling_vjp")
    _count("ladder_doubling", mode="reverse")
    return sbar, _unpack(v0bar)


def _form(op):
    """A form's fixed solve and reverse mode, by its operands' type."""
    if isinstance(op, LadderOperands):
        return ladder_solve, ladder_vjp
    if isinstance(op, DenseOperands):
        return ladder_dense, ladder_dense_vjp
    if isinstance(op, DoublingOperands):
        return ladder_doubling, ladder_doubling_vjp
    raise TypeError(f"no ladder form takes {type(op).__name__}")


class LadderFixed(torch.autograd.Function):
    """The fixed-iteration ladder solve as a differentiable function of
    the loads and the source phasors: forward a form's fixed solve,
    saving its iterates; backward that form's reverse mode — L1 and L2 on
    :class:`LadderOperands` (preorder), L3 on :class:`DenseOperands`, L4
    on :class:`DoublingOperands`.  ``apply(s_re, s_im, v0_re, v0_im, op,
    eps, max_iter)`` with the loads ``[B, nb, 3]`` (pu, in the operands'
    order) and ``v0 [B, 3]`` returns ``(v_re, v_im, ib_re, ib_im, il_re,
    il_im, iterations, converged, residual)``."""

    @staticmethod
    def forward(ctx, s_re, s_im, v0_re, v0_im, op, eps, max_iter):
        solve, _ = _form(op)
        s = C(s_re.contiguous(), s_im.contiguous())
        out = solve(s, C(v0_re.contiguous(), v0_im.contiguous()), op, eps,
                    max_iter, fixed=True, save=True)
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
        _, vjp = _form(ctx.op)

        def c(re, im):
            return C(re.contiguous(), im.contiguous())

        sbar, v0bar = vjp(saved, C(s_re, s_im), ctx.op, c(gv_re, gv_im),
                          c(gb_re, gb_im), c(gl_re, gl_im))
        return (sbar.re, sbar.im, v0bar.re, v0bar.im, None, None, None)
