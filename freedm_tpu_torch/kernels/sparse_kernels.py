"""Wrappers, plain versions and launch counters of the sparse Newton kernels.

==========================  =============================================  =====
wrapper                     replaces                                       route
==========================  =============================================  =====
:func:`sparse_assemble`     ``freedm_tpu/pf/sparse.py`` ``_assemble``      CUDA
                            (:307-344) + ``_residual_from`` (:372-375)
:func:`sparse_matvec`       ``freedm_tpu/pf/sparse.py`` ``_matvec``        CUDA
                            (:346-370)
:func:`gmres_block_orth`    the block step of ``freedm_tpu/pf/krylov.py``  CUDA
                            ``_pgmres_block`` (:451-471)
:func:`gmres_lstsq`         its least-squares finish (:479-482)            CUDA
==========================  =============================================  =====

All four live in ``csrc/sparse.cu`` (float64 and float32).  As in
:mod:`~freedm_tpu_torch.kernels.newton_kernels`, a wrapper given CPU
tensors runs its plain PyTorch version; given CUDA tensors it launches
its kernel or raises.  Each launch counts in :data:`LAUNCHES`.

Layouts, per lane: the state ``x`` and every Krylov vector are ``[B, N]``
with ``N = 2n`` (θ ‖ V halves); the value fill of one Newton step is
``ev [B, 4, 2m]`` in incidence-list order (CSR) — for entry ``r`` of
bus ``i``'s list, edge ``e`` to bus ``j``, row ``i``'s values at column
``j``: ``a, c, cv = c/V_j, av = a/V_j`` of ``e``'s side at ``i`` (the
reference's ``_JacValues`` ``*_ft`` where ``i`` is the from end, ``*_tf``
where it is the to end) — and ``bv [B, 6, n]`` — ``h_d, n_d, j_d, l_d,
p_calc, q_calc``.  S1 fills them in one launch in one of three modes
(:data:`FULL`, :data:`VALUES_F32`, :data:`RESIDUAL`), optionally with a
per-lane branch status ``[B, m]`` (each lane's admittances scaled and its
Ybus diagonal summed per lane; :data:`STATUS_LAUNCHES`).  The GMRES
basis is ``v_basis [B, mm+1, N]`` with ``valid [B, mm+1]``; the stored
chain is ``z_store``/``w_store [B, mm, N]``.

S3 runs a thread-block cluster per lane and S4's H pass several CTAs a
lane; how a lane splits is a :class:`ClusterPlan` from
:func:`block_orth_plan` or an :class:`LstsqPlan` from :func:`lstsq_plan`,
plain Python that the wrapper hands to the kernel.
:func:`gmres_lstsq_jacobi` mirrors S4's Jacobi least squares in PyTorch
for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from freedm_tpu_torch.kernels import build

Tensor = torch.Tensor

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {
    "sparse_assemble": 0,
    "sparse_matvec": 0,
    "gmres_block_orth": 0,
    "gmres_lstsq": 0,
}
#: S1's launches by mode (their sum is ``LAUNCHES["sparse_assemble"]``).
ASSEMBLE_LAUNCHES: Dict[str, int] = {"FULL": 0, "VALUES_F32": 0,
                                     "RESIDUAL": 0}
#: Those of S1's launches, by mode, that took a per-lane branch status.
STATUS_LAUNCHES: Dict[str, int] = dict.fromkeys(ASSEMBLE_LAUNCHES, 0)
_launch_lock = threading.Lock()

#: S1's modes (``mode=`` of :func:`sparse_assemble`): the value fill in
#: the working dtype, ``(ev, bv, f)``; the value fill in float32 from
#: float64 arithmetic with ``f`` in float64 (the mixed Newton step: each
#: value rounded once, the bits of the full mode's ``ev``/``bv`` cast to
#: float32); the residual alone, ``(p [B, n], q [B, n], f)``, the bits of
#: the full mode's ``bv[:, 4]``, ``bv[:, 5]`` and ``f``.
FULL, VALUES_F32, RESIDUAL = 0, 1, 2
_MODE_NAMES = ("FULL", "VALUES_F32", "RESIDUAL")

#: The reference's breakdown threshold (``brk`` in ``_pgmres_block``).
BREAKDOWN = 1e-30

#: Limits of the CUDA kernels (``csrc/sparse.cu``): block size ``s`` and
#: Krylov dimension ``mm`` of one GMRES cycle.
MAX_BLOCK = 8
MAX_KRYLOV = 32

#: S3 runs a cluster of at most this many CTAs per lane (the portable
#: cluster size), each with at most ``SMEM_LIMIT`` bytes of
#: shared memory (what a block may use on Hopper).
MAX_CLUSTER = 8
SMEM_LIMIT = 232_448
#: S3's shared memory ahead of the rows it keeps (``orth_header_bytes`` in
#: ``csrc/sparse.cu``): two buffers of 256 float64 partials, then 256
#: coefficients, the 8 x 8 factor, 8 row flags and 33 basis-row flags in
#: the working dtype, rounded up to 16 bytes.
_ORTH_PRODUCTS = 256
_ORTH_SMALL = _ORTH_PRODUCTS + MAX_BLOCK * MAX_BLOCK + MAX_BLOCK + MAX_KRYLOV + 1
#: S4 streams the Krylov vectors in tiles of this many columns, over at
#: most this many CTAs a lane.
LSTSQ_TILE = 64
LSTSQ_CTAS = 8
#: Jacobi sweeps S4 runs at most (``kMaxSweeps``).
MAX_SWEEPS = 60


def _count(name: str, mode: Optional[str] = None,
           status: bool = False) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
        if mode is not None:
            ASSEMBLE_LAUNCHES[mode] += 1
            if status:
                STATUS_LAUNCHES[mode] += 1


def reset_launches() -> None:
    with _launch_lock:
        for counts in (LAUNCHES, ASSEMBLE_LAUNCHES, STATUS_LAUNCHES):
            for k in counts:
                counts[k] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def assemble_launches() -> Dict[str, int]:
    """S1's launches by mode since the last :func:`reset_launches`."""
    with _launch_lock:
        return dict(ASSEMBLE_LAUNCHES)


def status_launches() -> Dict[str, int]:
    """S1's launches with a per-lane status, by mode, since the last
    :func:`reset_launches`."""
    with _launch_lock:
        return dict(STATUS_LAUNCHES)


class SparseOperands(NamedTuple):
    """What the sparse kernels need of one bus system, on one device.

    The bus-sorted incidence list in CSR form, int32: ``inc_ptr [n+1]``,
    ``inc_code [2m]`` (``2·edge + side``, side 0 where the bus is the
    edge's from end, 1 where it is the to end; per bus the from-end
    edges come first, then the to-end edges, each in ascending edge
    order) and ``inc_nbr [2m]`` (the edge's other end).  Float arrays
    are in the working dtype: per list entry the two-port admittance of
    its side as (re, im), ``inc_g``/``inc_b [2m]`` (the branch's ``yft``
    at its from end's entry, ``ytf`` at its to end's), the Ybus diagonal
    ``g_d``/``b_d`` and the masks ``th_free``, ``v_free``, ``v_set``
    ``[n]``.  For S1's per-lane branch status: per list entry the
    self admittance of its side, ``inc_gs``/``inc_bs [2m]`` (the
    branch's ``yff`` at its from end's entry, ``ytt`` at its to end's),
    and the bus shunts ``g_sh``/``b_sh [n]``.
    """

    inc_ptr: Tensor
    inc_code: Tensor
    inc_nbr: Tensor
    inc_g: Tensor
    inc_b: Tensor
    g_d: Tensor
    b_d: Tensor
    th_free: Tensor
    v_free: Tensor
    v_set: Tensor
    inc_gs: Tensor
    inc_bs: Tensor
    g_sh: Tensor
    b_sh: Tensor

    @property
    def n(self) -> int:
        return int(self.g_d.shape[0])

    @property
    def m(self) -> int:
        return int(self.inc_code.shape[0]) // 2

    def to_dtype(self, dtype: torch.dtype) -> "SparseOperands":
        """The same operands with the float arrays cast to ``dtype``."""
        return SparseOperands(*(
            t if t.dtype == torch.int32 else t.to(dtype) for t in self
        ))

    def inc_rows(self) -> Tensor:
        """The bus whose list holds each entry, ``[2m]`` int64."""
        return torch.repeat_interleave(
            torch.arange(self.n, device=self.inc_ptr.device),
            torch.diff(self.inc_ptr.long()))


# ---------------------------------------------------------------------------
# Launch plans of S3 and S4 (plain Python: the CPU tests hold them)
# ---------------------------------------------------------------------------


class ClusterPlan(NamedTuple):
    """How S3 splits one lane over a cluster of CTAs.

    CTA ``c`` of a lane's cluster owns the columns ``[bounds[c],
    bounds[c + 1])`` of the Krylov vectors — the slices of ``c · nvec //
    cluster``, which the kernel recomputes from its rank.  ``width`` is
    the widest slice, ``smem`` the dynamic shared memory of one CTA in
    bytes.  ``resident``: the CTA keeps its slice of the basis rows and
    the block in shared memory; otherwise it reads them from global
    memory in every pass, with the same arithmetic in the same order.
    """

    cluster: int
    bounds: Tuple[int, ...]
    width: int
    smem: int
    resident: bool


@functools.lru_cache(maxsize=1024)
def block_orth_plan(nvec: int, nrows: int, s: int, j0: int, itemsize: int,
                    resident: Optional[bool] = None) -> ClusterPlan:
    """S3's plan for ``v_basis [B, nrows, nvec]``, a block of ``s`` rows
    after basis row ``j0``, in a dtype of ``itemsize`` bytes.

    A slice of at least 32 columns per CTA, at most ``MAX_CLUSTER`` CTAs:
    8 at mesh2000 (N = 4000, 500 columns each), 7 at mesh118 (N = 236,
    slices of 33 and 34).  The CTA keeps the j0 + 1 basis rows and the s
    block rows of its slice resident when they fit (``resident=None``);
    ``resident=False`` forces the streamed form.  Raises ``ValueError`` on
    a block the kernel does not take."""
    if not (1 <= s <= MAX_BLOCK and 0 <= j0 and j0 + 1 + s <= nrows
            and nrows <= MAX_KRYLOV + 1 and nvec >= 1):
        raise ValueError(
            f"unsupported block: s={s}, j0={j0}, {nrows} basis rows of "
            f"{nvec} (s <= {MAX_BLOCK}, mm <= {MAX_KRYLOV})"
        )
    header = -(-(2 * _ORTH_PRODUCTS * 8 + _ORTH_SMALL * itemsize) // 16) * 16
    cluster = max(1, min(MAX_CLUSTER, nvec // 32))
    width = -(-nvec // cluster)
    fits = header + width * (j0 + 1 + s) * itemsize <= SMEM_LIMIT
    if resident is None:
        resident = fits
    elif resident and not fits:
        raise ValueError(f"{j0 + 1 + s} rows of {width} columns do not fit "
                         f"in {SMEM_LIMIT} bytes of shared memory")
    smem = header + (width * (j0 + 1 + s) * itemsize if resident else 0)
    bounds = tuple(c * nvec // cluster for c in range(cluster + 1))
    return ClusterPlan(cluster, bounds, width, smem, bool(resident))


class LstsqPlan(NamedTuple):
    """How S4's H pass splits one lane over CTAs.

    The ``nvec`` columns fall into ``ceil(nvec / LSTSQ_TILE)`` tiles; CTA
    ``c`` of a lane owns the tiles ``[c T // ctas, (c + 1) T // ctas)``,
    the columns ``[bounds[c], bounds[c + 1])``, and writes its float64
    partials of H.  ``smem`` is the dynamic shared memory of one CTA in
    bytes (``lstsq_smem_bytes`` in ``csrc/sparse.cu``)."""

    ctas: int
    bounds: Tuple[int, ...]
    smem: int


@functools.lru_cache(maxsize=256)
def lstsq_plan(nvec: int, mm: int, itemsize: int) -> LstsqPlan:
    """S4's plan for a cycle of Krylov dimension ``mm`` over ``nvec``
    columns in a dtype of ``itemsize`` bytes: at most ``LSTSQ_CTAS`` CTAs
    a lane and at least one tile each — 8 at mesh2000 (63 tiles), 4 at
    mesh118 (N = 236).  Raises ``ValueError`` on a cycle the kernels do
    not take."""
    if not 1 <= mm <= MAX_KRYLOV:
        raise ValueError(f"unsupported Krylov dimension {mm} "
                         f"(1 <= mm <= {MAX_KRYLOV})")
    if nvec < 1:
        raise ValueError(f"unsupported vector length {nvec}")
    tiles = -(-nvec // LSTSQ_TILE)
    ctas = min(LSTSQ_CTAS, tiles)
    header = -(-(MAX_KRYLOV + 1) * itemsize // 16) * 16
    stride = LSTSQ_TILE + 16 // itemsize
    smem = header + 2 * (2 * mm + 1) * stride * itemsize
    bounds = tuple(min(nvec, (c * tiles // ctas) * LSTSQ_TILE)
                   for c in range(ctas + 1))
    return LstsqPlan(ctas, bounds, smem)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def _seg(vals: Tensor, idx: Tensor, n: int) -> Tensor:
    """``jax.ops.segment_sum`` along dim 1 of ``[B, k]`` values."""
    out = vals.new_zeros(vals.shape[0], n)
    return out.index_add_(1, idx, vals)


def sparse_assemble_plain(x, p_sched, q_sched, op: SparseOperands,
                          mode: int = FULL, status: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """S1's plain version in each mode (:data:`FULL`: ``(ev [B, 4, 2m],
    bv [B, 6, n], f [B, 2n])``); :data:`VALUES_F32` and :data:`RESIDUAL`
    are the full mode's values cast and sliced.  ``status [B, m]`` scales
    each lane's branch admittances (the reference's
    ``branch_admittances(sys, status)``), and the Ybus diagonal becomes
    the lane's: its self terms summed apart by side, then the shunt."""
    _check_mode(mode, x.dtype)
    n = op.n
    rows, j = op.inc_rows(), op.inc_nbr.long()
    to = (op.inc_code & 1).bool()
    inc_g, inc_b, g_d, b_d = op.inc_g, op.inc_b, op.g_d, op.b_d
    if status is not None:
        st = status[:, (op.inc_code >> 1).long()]
        inc_g, inc_b = inc_g * st, inc_b * st
        gs, bs = op.inc_gs * st, op.inc_bs * st
        zs = torch.zeros_like(gs)
        g_d = (_seg(torch.where(to, zs, gs), rows, n)
               + _seg(torch.where(to, gs, zs), rows, n) + op.g_sh)
        b_d = (_seg(torch.where(to, zs, bs), rows, n)
               + _seg(torch.where(to, bs, zs), rows, n) + op.b_sh)
    theta, v = x[:, :n], x[:, n:]
    th_i, th_j, v_i, v_j = theta[:, rows], theta[:, j], v[:, rows], v[:, j]
    e = torch.where(to, th_j, th_i) - torch.where(to, th_i, th_j)
    ce, se = torch.cos(e), torch.sin(e)
    vv = torch.where(to, v_j, v_i) * torch.where(to, v_i, v_j)
    sb = torch.where(to, -inc_b, inc_b)
    c = vv * (inc_g * ce + sb * se)
    a0 = vv * (inc_g * se - sb * ce)
    a = torch.where(to, -a0, a0)
    zero = torch.zeros_like(c)
    v2 = v * v
    p = (_seg(torch.where(to, zero, c), rows, n)
         + _seg(torch.where(to, c, zero), rows, n) + v2 * g_d)
    q = (_seg(torch.where(to, zero, a), rows, n)
         + _seg(torch.where(to, a, zero), rows, n) - v2 * b_d)
    f_p = torch.where(op.th_free > 0, p - p_sched, theta)
    f_q = torch.where(op.v_free > 0, q - q_sched, v - op.v_set)
    f = torch.cat([f_p, f_q], dim=1)
    if mode == RESIDUAL:
        return p, q, f
    ev = torch.stack([a, c, c / v_j, a / v_j], dim=1)
    bv = torch.stack([-v2 * b_d - q, v * g_d + p / v,
                      -v2 * g_d + p, -v * b_d + q / v, p, q], dim=1)
    if mode == VALUES_F32:
        return ev.to(torch.float32), bv.to(torch.float32), f
    return ev, bv, f


def sparse_matvec_plain(ev, bv, u, op: SparseOperands) -> Tensor:
    """S2's plain version: ``J·u`` over the pattern, ``[B, 2n]``."""
    n = op.n
    rows, j = op.inc_rows(), op.inc_nbr.long()
    a, c, cv, av = ev.unbind(1)
    h_d, n_d, j_d, l_d = bv[:, 0], bv[:, 1], bv[:, 2], bv[:, 3]
    uth, uv = u[:, :n], u[:, n:]
    yp = _seg(a * uth[:, j] + cv * uv[:, j], rows, n) + h_d * uth + n_d * uv
    yq = _seg(-c * uth[:, j] + av * uv[:, j], rows, n) + j_d * uth + l_d * uv
    free = torch.cat([op.th_free, op.v_free])
    return torch.where(free > 0, torch.cat([yp, yq], dim=1), u)


def _cholesky_or_nan(a: Tensor) -> Tensor:
    """Lower Cholesky factors of ``[B, s, s]``; a lane whose matrix is
    not positive definite (or not finite) gets an all-NaN lower triangle,
    as ``jnp.linalg.cholesky`` returns — never a partial factor."""
    finite = torch.isfinite(a).flatten(1).all(dim=1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    fac, info = torch.linalg.cholesky_ex(
        torch.where(finite[:, None, None], a, eye))
    bad = (info != 0) | ~finite
    nan_lower = torch.full_like(fac, float("nan")).tril()
    return torch.where(bad[:, None, None], nan_lower, fac)


def _dots(a: Tensor, b: Tensor) -> Tensor:
    """``a @ bᵀ`` over lanes, accumulated in float64 and rounded to the
    working dtype (S3's dot products, as the kernel takes them)."""
    return (a.double() @ b.double().mT).to(a.dtype)


def gmres_block_orth_plain(v_basis, valid, w_blk, j0: int) -> None:
    """S3's plain version, in place on ``v_basis`` and ``valid``."""
    dtype = v_basis.dtype
    s = w_blk.shape[1]
    fin = torch.finfo(dtype)
    rows = torch.arange(v_basis.shape[1], device=v_basis.device)
    mask = valid * (rows <= j0).to(dtype)
    vb = v_basis * mask[:, :, None]
    q = w_blk
    for _ in range(2):
        q = q - _dots(q, vb) @ vb
    newv = torch.ones(valid.shape[0], s, dtype=dtype, device=valid.device)
    eye = torch.eye(s, dtype=dtype, device=valid.device)
    for _ in range(2):
        g = _dots(q, q)
        d = torch.diagonal(g, dim1=1, dim2=2)
        newv = newv * (d > BREAKDOWN).to(dtype)
        ridge = (torch.clamp(torch.amax(d, dim=1), min=fin.tiny) * fin.eps * s
                 + fin.tiny)
        l_fac = _cholesky_or_nan(g + ridge[:, None, None] * eye)
        q = torch.linalg.solve_triangular(l_fac, q, upper=False)
    q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
    v_basis[:, j0 + 1:j0 + 1 + s] = q * newv[:, :, None]
    valid[:, j0 + 1:j0 + 1 + s] = newv


def gmres_lstsq_plain(v_basis, valid, w_store, z_store, beta) -> Tensor:
    """S4's plain version: ``x [B, N]`` from the SVD minimum-norm
    ``min ‖β e₁ − H y‖`` with ``jnp.linalg.lstsq``'s cutoff, ε of the
    working dtype (a lane with a non-finite H or β gets NaN, as the
    reference's SVD gives).  H and its SVD are float64 for either dtype,
    as in the kernel; ``x = Zᵀ y`` is in the working dtype."""
    dtype = v_basis.dtype
    mm = w_store.shape[1]
    h = ((v_basis * valid[:, :, None]).double()
         @ w_store.double().mT)  # [B, mm+1, mm]
    bad = ~torch.isfinite(h).flatten(1).all(dim=1) | ~torch.isfinite(beta)
    h = torch.where(bad[:, None, None], torch.zeros_like(h), h)
    u, sv, vh = torch.linalg.svd(h, full_matrices=False)
    cut = torch.finfo(dtype).eps * max(mm + 1, mm) * sv[:, :1]
    keep = (sv > 0) & (sv >= cut)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, sv, torch.ones_like(sv)),
                        torch.zeros_like(sv))
    utb = u[:, 0, :] * beta.double()[:, None]  # U^T (β e₁)
    y = (vh.mT @ (s_inv * utb)[:, :, None])[:, :, 0].to(dtype)
    x = (z_store.mT @ y[:, :, None])[:, :, 0]
    return torch.where(bad[:, None], torch.full_like(x, float("nan")), x)


def jacobi_lstsq(h: Tensor, beta: Tensor,
                 cut_eps: float) -> Tuple[Tensor, Tensor]:
    """S4's least squares as its kernel runs it, in float64: the SVD
    minimum-norm ``y`` of ``min ‖β e₁ − h y‖`` for ``h [B, mm+1, mm]``
    by one-sided Jacobi — column pairs in the kernel's round-robin order,
    its rotation formulas and its convergence test ``|γ| > ε √α √β`` with
    float64 ε, at most ``MAX_SWEEPS`` sweeps — then the cutoff ``σ > 0``
    and ``σ ≥ cut_eps · (mm+1) · σ_max``.  Returns ``(y [B, mm], sweeps
    [B])``, ``sweeps`` the sweeps each lane ran (the last one rotates no
    pair).  The dot products are summed in another order than the
    kernel's."""
    lanes, mr, mm = h.shape
    nc = mm + (mm & 1)
    a = h.new_zeros(lanes, mr, nc)
    a[:, :, :mm] = h
    v = torch.eye(nc, dtype=h.dtype, device=h.device).repeat(lanes, 1, 1)
    eps = torch.finfo(torch.float64).eps
    live = torch.ones(lanes, dtype=torch.bool, device=h.device)
    sweeps = torch.zeros(lanes, dtype=torch.int64, device=h.device)
    pos = torch.arange(nc, device=h.device)
    for _ in range(MAX_SWEEPS):
        rotated = torch.zeros_like(live)
        for rnd in range(nc - 1):
            players = torch.where(pos == 0, 0, 1 + (pos - 1 + rnd) % (nc - 1))
            p, q = players[:nc // 2], players.flip(0)[:nc // 2]
            ap, aq = a[:, :, p], a[:, :, q]
            al = (ap * ap).sum(1)
            be = (aq * aq).sum(1)
            ga = (ap * aq).sum(1)
            rot = ((ga != 0) & (ga.abs() > eps * al.sqrt() * be.sqrt())
                   & live[:, None])
            zeta = (be - al) / (2 * torch.where(rot, ga, torch.ones_like(ga)))
            t = (torch.where(zeta >= 0, 1.0, -1.0)
                 / (zeta.abs() + torch.sqrt(1 + zeta * zeta)))
            c = torch.where(rot, 1 / torch.sqrt(1 + t * t), 1.0)
            sn = torch.where(rot, c * t, 0.0)
            c, sn = c[:, None], sn[:, None]
            a[:, :, p], a[:, :, q] = c * ap - sn * aq, sn * ap + c * aq
            vp, vq = v[:, :mm, p], v[:, :mm, q]
            v[:, :mm, p], v[:, :mm, q] = c * vp - sn * vq, sn * vp + c * vq
            rotated |= rot.any(1)
        sweeps += live.long()
        live &= rotated
        if not bool(live.any()):
            break
    sv = torch.sqrt((a[:, :, :mm] * a[:, :, :mm]).sum(1))
    cut = cut_eps * mr * sv.amax(1, keepdim=True)
    keep = (sv > 0) & (sv >= cut)
    safe = torch.where(keep, sv, torch.ones_like(sv))
    coef = torch.where(keep, (1 / safe) * ((a[:, 0, :mm] / safe)
                                           * beta[:, None]), 0.0)
    return (v[:, :mm, :mm] @ coef[:, :, None])[:, :, 0], sweeps


def gmres_lstsq_jacobi(v_basis, valid, w_store, z_store,
                       beta) -> Tuple[Tensor, Tensor]:
    """S4's algorithm in PyTorch (:func:`jacobi_lstsq` on the float64 H):
    ``(x [B, N], sweeps [B])``.  For the tests and ``chip_smoke.py``; the
    solvers take :func:`gmres_lstsq`."""
    dtype = v_basis.dtype
    h = (v_basis * valid[:, :, None]).double() @ w_store.double().mT
    bad = ~torch.isfinite(h).flatten(1).all(dim=1) | ~torch.isfinite(beta)
    h = torch.where(bad[:, None, None], torch.zeros_like(h), h)
    y, sweeps = jacobi_lstsq(h, beta.double(), torch.finfo(dtype).eps)
    x = (z_store.mT @ y.to(dtype)[:, :, None])[:, :, 0]
    return torch.where(bad[:, None], torch.full_like(x, float("nan")), x), sweeps


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_lock = threading.Lock()
_fns: Dict[Tuple[str, torch.dtype], object] = {}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_SIGS = {
    "sparse_assemble": [_P] * 21 + [_I] * 4 + [_P],
    "sparse_matvec": [_P] * 8 + [_I] * 3 + [_P],
    "gmres_block_orth": [_P] * 3 + [_I] * 9 + [_P],
    "gmres_lstsq": [_P] * 8 + [_I] * 5 + [_P],
}


def _fn(name: str, dtype: torch.dtype):
    """The C entry point of kernel ``name`` for ``dtype``; the library is
    built and loaded at the first call."""
    fn = _fns.get((name, dtype))
    if fn is None:
        with _lib_lock:
            if not _fns:
                lib = build.load("sparse")
                for dt, suffix in _SUFFIX.items():
                    for kname, args in _SIGS.items():
                        f = getattr(lib, f"{kname}_{suffix}")
                        f.argtypes = args
                        f.restype = _I
                        _fns[(kname, dt)] = f
        fn = _fns[(name, dtype)]
    return fn


def _sparse_lib() -> None:
    """Build and load the kernels' library now (it happens at the first
    launch otherwise)."""
    _fn("sparse_matvec", torch.float64)


def _want(like: Tensor, spec: Dict[str, Tuple[Tensor, torch.dtype, tuple]]):
    """Check device, dtype, shape and contiguity before a launch."""
    if like.dtype not in _SUFFIX:
        raise TypeError(f"kernels take float64 or float32, got {like.dtype}")
    dev = like.device
    for name, (t, dtype, shape) in spec.items():
        if t.dtype is not dtype or t.device != dev:
            raise ValueError(
                f"{name} must be {dtype} on {dev}, got {t.dtype} on "
                f"{t.device}"
            )
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {tuple(shape)} tensor, got "
                f"{tuple(t.shape)}"
            )


def _op_spec(op: SparseOperands, dtype) -> dict:
    n, m = op.n, op.m
    i32 = torch.int32
    spec = {"inc_ptr": (op.inc_ptr, i32, (n + 1,)),
            "inc_code": (op.inc_code, i32, (2 * m,)),
            "inc_nbr": (op.inc_nbr, i32, (2 * m,)),
            "inc_g": (op.inc_g, dtype, (2 * m,)),
            "inc_b": (op.inc_b, dtype, (2 * m,)),
            "inc_gs": (op.inc_gs, dtype, (2 * m,)),
            "inc_bs": (op.inc_bs, dtype, (2 * m,))}
    for name in ("g_d", "b_d", "th_free", "v_free", "v_set", "g_sh", "b_sh"):
        spec[name] = (getattr(op, name), dtype, (n,))
    return spec


#: Operand sets already checked, by (id, dtype, device), with their
#: device pointers; each entry keeps its set alive, so an id is not reused
#: while it is here.  A solve calls S2 hundreds of times over one or two
#: sets, and a check costs more host time than the launch.
_checked_ops: Dict[tuple, Tuple[SparseOperands, Dict[str, int]]] = {}


def _op_ptrs(op: SparseOperands, like: Tensor) -> Dict[str, int]:
    """The device pointers of ``op``'s arrays, checked against ``like``'s
    dtype and device the first time this set is seen."""
    key = (id(op), like.dtype, like.get_device())
    hit = _checked_ops.get(key)
    if hit is not None and hit[0] is op:
        return hit[1]
    _want(like, _op_spec(op, like.dtype))
    ptrs = {name: t.data_ptr() for name, t in zip(op._fields, op)}
    with _launch_lock:
        if len(_checked_ops) >= 64:
            _checked_ops.clear()
        _checked_ops[key] = (op, ptrs)
    return ptrs


def _check_mode(mode: int, dtype: torch.dtype) -> None:
    if mode not in (FULL, VALUES_F32, RESIDUAL):
        raise ValueError(f"unknown sparse_assemble mode {mode!r}")
    if mode == VALUES_F32 and dtype != torch.float64:
        raise ValueError("VALUES_F32 rounds float64 arithmetic to float32; "
                         f"x is {dtype}")


def _need_cuda(t: Tensor, name: str) -> None:
    """A wrapper launches only on a CUDA tensor (a CPU one takes the plain
    version before this); any other device is refused here, before the
    library is loaded."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{t.device}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch_on(t: Tensor):
    """``(context, stream)`` for a launch on ``t``'s device: a context that
    makes the device current (a no-op when it already is) and the raw
    handle of its current stream."""
    idx = t.get_device()
    ctx = (contextlib.nullcontext() if idx == torch.cuda.current_device()
           else torch.cuda.device(idx))
    return ctx, torch._C._cuda_getCurrentRawStream(idx)


def sparse_assemble(x, p_sched, q_sched, op: SparseOperands,
                    mode: int = FULL, status: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """S1: the value fill and the masked mismatch at ``x [B, 2n]``, in one
    launch.

    ``mode`` :data:`FULL` returns ``(ev [B, 4, 2m], bv [B, 6, n], f [B,
    2n])`` in ``x``'s dtype; :data:`VALUES_F32` (``x`` float64) the same
    with ``ev`` and ``bv`` in float32; :data:`RESIDUAL` ``(p [B, n], q [B,
    n], f)``.  ``status [B, m]`` (``x``'s dtype) scales each lane's branch
    admittances and makes its Ybus diagonal per lane; without it the
    kernel is the all-in-service one, which reads the stored diagonal."""
    if x.device.type == "cpu":
        return sparse_assemble_plain(x, p_sched, q_sched, op, mode, status)
    _need_cuda(x, "sparse_assemble")
    _check_mode(mode, x.dtype)
    n, m = op.n, op.m
    lanes = x.shape[0]
    dt, dev = x.dtype, x.device
    lane_args = [("x", x, 2 * n), ("p_sched", p_sched, n),
                 ("q_sched", q_sched, n)]
    if status is not None:
        lane_args.append(("status", status, m))
    for name, t, cols in lane_args:
        if (t.dtype is not dt or t.device != dev or t.dim() != 2
                or t.shape[0] != lanes or t.shape[1] != cols
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dt} [{lanes}, {cols}] tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    o = _op_ptrs(op, x)
    fn = _fn("sparse_assemble", dt)
    ctx, stream = _launch_on(x)
    # One allocation an output: slicing one buffer into views cost more
    # host time a call than the allocations it saved (PERF.md).
    with ctx:
        if mode == RESIDUAL:
            ev = torch.empty(lanes, n, dtype=dt, device=dev)  # P
            bv = torch.empty(lanes, n, dtype=dt, device=dev)  # Q
        else:
            vdt = torch.float32 if mode == VALUES_F32 else dt
            ev = torch.empty(lanes, 4, 2 * m, dtype=vdt, device=dev)
            bv = torch.empty(lanes, 6, n, dtype=vdt, device=dev)
        f = torch.empty(lanes, 2 * n, dtype=dt, device=dev)
        rc = fn(x.data_ptr(), p_sched.data_ptr(), q_sched.data_ptr(),
                o["th_free"], o["v_free"], o["v_set"], o["inc_g"],
                o["inc_b"], o["g_d"], o["b_d"], o["inc_ptr"], o["inc_code"],
                o["inc_nbr"], None if status is None else status.data_ptr(),
                o["inc_gs"], o["inc_bs"], o["g_sh"], o["b_sh"],
                ev.data_ptr(), bv.data_ptr(), f.data_ptr(),
                lanes, n, m, mode, stream)
    _raise_on(rc, "sparse_assemble")
    _count("sparse_assemble", _MODE_NAMES[mode], status is not None)
    return ev, bv, f


def sparse_matvec(ev, bv, u, op: SparseOperands) -> Tensor:
    """S2: ``J·u`` for ``u [B, 2n]`` over the value fill ``(ev, bv)``;
    pinned rows pass ``u`` through."""
    if u.device.type == "cpu":
        return sparse_matvec_plain(ev, bv, u, op)
    n, m = op.n, op.m
    lanes = u.shape[0]
    _want(u, {"u": (u, u.dtype, (lanes, 2 * n)),
              "ev": (ev, u.dtype, (lanes, 4, 2 * m)),
              "bv": (bv, u.dtype, (lanes, 6, n))})
    _need_cuda(u, "sparse_matvec")
    o = _op_ptrs(op, u)
    fn = _fn("sparse_matvec", u.dtype)
    ctx, stream = _launch_on(u)
    with ctx:
        y = torch.empty_like(u)
        rc = fn(ev.data_ptr(), bv.data_ptr(), u.data_ptr(), o["th_free"],
                o["v_free"], o["inc_ptr"], o["inc_nbr"], y.data_ptr(), lanes,
                n, m, stream)
    _raise_on(rc, "sparse_matvec")
    _count("sparse_matvec")
    return y


def gmres_block_orth(v_basis, valid, w_blk, j0: int) -> None:
    """S3: orthogonalize the candidate block ``w_blk [B, s, N]`` against
    the valid basis rows ``0..j0`` and write it, CholQR2-normalized, into
    ``v_basis[:, j0+1 : j0+1+s]`` and its row mask into ``valid`` (in
    place)."""
    if v_basis.device.type == "cpu":
        gmres_block_orth_plain(v_basis, valid, w_blk, j0)
        return
    _, nrows, nvec = v_basis.shape
    j0 = int(j0)
    plan = block_orth_plan(nvec, nrows, w_blk.shape[1], j0,
                           v_basis.element_size())
    _launch_block_orth(v_basis, valid, w_blk, j0, plan)


def _launch_block_orth(v_basis, valid, w_blk, j0: int,
                       plan: ClusterPlan) -> None:
    lanes, nrows, nvec = v_basis.shape
    s = w_blk.shape[1]
    dt = v_basis.dtype
    _want(v_basis, {"v_basis": (v_basis, dt, (lanes, nrows, nvec)),
                    "valid": (valid, dt, (lanes, nrows)),
                    "w_blk": (w_blk, dt, (lanes, s, nvec))})
    _need_cuda(v_basis, "gmres_block_orth")
    fn = _fn("gmres_block_orth", dt)
    ctx, stream = _launch_on(v_basis)
    with ctx:
        rc = fn(v_basis.data_ptr(), valid.data_ptr(), w_blk.data_ptr(), lanes,
                nrows, s, nvec, j0, plan.cluster, plan.width, plan.smem,
                int(plan.resident), stream)
    _raise_on(rc, "gmres_block_orth")
    _count("gmres_block_orth")


def gmres_lstsq(v_basis, valid, w_store, z_store, beta) -> Tensor:
    """S4: the cycle's update ``x = Zᵀ y`` with ``y`` the SVD
    minimum-norm solution of ``min ‖β e₁ − (V·valid) Wᵀ y‖``."""
    if v_basis.device.type == "cpu":
        return gmres_lstsq_plain(v_basis, valid, w_store, z_store, beta)
    lanes, nrows, nvec = v_basis.shape
    mm = nrows - 1
    plan = lstsq_plan(nvec, mm, v_basis.element_size())
    dt = v_basis.dtype
    _want(v_basis, {"v_basis": (v_basis, dt, (lanes, nrows, nvec)),
                    "valid": (valid, dt, (lanes, nrows)),
                    "w_store": (w_store, dt, (lanes, mm, nvec)),
                    "z_store": (z_store, dt, (lanes, mm, nvec)),
                    "beta": (beta, dt, (lanes,))})
    _need_cuda(v_basis, "gmres_lstsq")
    fn = _fn("gmres_lstsq", dt)
    ctx, stream = _launch_on(v_basis)
    with ctx:
        x = torch.empty(lanes, nvec, dtype=dt, device=v_basis.device)
        # Scratch: H's float64 partials [lanes, ctas, mm+1, mm], then y.
        nh = lanes * plan.ctas * nrows * mm
        scratch = torch.empty(nh + lanes * mm, dtype=torch.float64,
                              device=v_basis.device)
        rc = fn(v_basis.data_ptr(), valid.data_ptr(), w_store.data_ptr(),
                z_store.data_ptr(), beta.data_ptr(), x.data_ptr(),
                scratch.data_ptr(), scratch.data_ptr() + 8 * nh, lanes, mm,
                nvec, plan.ctas, plan.smem, stream)
    _raise_on(rc, "gmres_lstsq")
    _count("gmres_lstsq")
    return x
