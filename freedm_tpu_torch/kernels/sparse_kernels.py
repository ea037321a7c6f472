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
``ev [B, 8, m]`` — the edge values ``a_ft, a_tf, c_ft, c_tf, cv_ft,
cv_tf, av_ft, av_tf`` in the reference's ``_JacValues`` order — and
``bv [B, 6, n]`` — ``h_d, n_d, j_d, l_d, p_calc, q_calc``.  The GMRES
basis is ``v_basis [B, mm+1, N]`` with ``valid [B, mm+1]``; the stored
chain is ``z_store``/``w_store [B, mm, N]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple

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
_launch_lock = threading.Lock()

#: The reference's breakdown threshold (``brk`` in ``_pgmres_block``).
BREAKDOWN = 1e-30

#: Limits of the CUDA kernels (``csrc/sparse.cu``): block size ``s`` and
#: Krylov dimension ``mm`` of one GMRES cycle.
MAX_BLOCK = 8
MAX_KRYLOV = 32


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


class SparseOperands(NamedTuple):
    """What the sparse kernels need of one bus system, on one device.

    Index arrays are int32: the branch ends ``f_idx``/``t_idx`` ``[m]``,
    and the bus-sorted incidence list in CSR form — ``inc_ptr [n+1]``,
    ``inc_code [2m]`` (``2·edge + side``, side 0 where the bus is the
    edge's from end, 1 where it is the to end; per bus the from-end
    edges come first, then the to-end edges, each in ascending edge
    order) and ``inc_nbr [2m]`` (the edge's other end).  Float arrays
    are in the working dtype: the per-edge two-port admittances
    ``yft``/``ytf`` as (re, im), the Ybus diagonal ``g_d``/``b_d`` and
    the masks ``th_free``, ``v_free``, ``v_set`` ``[n]``.
    """

    f_idx: Tensor
    t_idx: Tensor
    inc_ptr: Tensor
    inc_code: Tensor
    inc_nbr: Tensor
    yft_re: Tensor
    yft_im: Tensor
    ytf_re: Tensor
    ytf_im: Tensor
    g_d: Tensor
    b_d: Tensor
    th_free: Tensor
    v_free: Tensor
    v_set: Tensor

    @property
    def n(self) -> int:
        return int(self.g_d.shape[0])

    @property
    def m(self) -> int:
        return int(self.f_idx.shape[0])

    def to_dtype(self, dtype: torch.dtype) -> "SparseOperands":
        """The same operands with the float arrays cast to ``dtype``."""
        return SparseOperands(*(
            t if t.dtype == torch.int32 else t.to(dtype) for t in self
        ))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the on-card comparison's reference)
# ---------------------------------------------------------------------------


def _seg(vals: Tensor, idx: Tensor, n: int) -> Tensor:
    """``jax.ops.segment_sum`` along dim 1 of ``[B, k]`` values."""
    out = vals.new_zeros(vals.shape[0], n)
    return out.index_add_(1, idx, vals)


def sparse_assemble_plain(x, p_sched, q_sched,
                          op: SparseOperands) -> Tuple[Tensor, Tensor, Tensor]:
    """S1's plain version: ``(ev [B, 8, m], bv [B, 6, n], f [B, 2n])``."""
    n = op.n
    fi, ti = op.f_idx.long(), op.t_idx.long()
    theta, v = x[:, :n], x[:, n:]
    v_f, v_t = v[:, fi], v[:, ti]
    e = theta[:, fi] - theta[:, ti]
    ce, se = torch.cos(e), torch.sin(e)
    vv = v_f * v_t
    c_ft = vv * (op.yft_re * ce + op.yft_im * se)
    a_ft = vv * (op.yft_re * se - op.yft_im * ce)
    c_tf = vv * (op.ytf_re * ce - op.ytf_im * se)
    a_tf = -vv * (op.ytf_re * se + op.ytf_im * ce)
    v2 = v * v
    p = _seg(c_ft, fi, n) + _seg(c_tf, ti, n) + v2 * op.g_d
    q = _seg(a_ft, fi, n) + _seg(a_tf, ti, n) - v2 * op.b_d
    ev = torch.stack([a_ft, a_tf, c_ft, c_tf, c_ft / v_t, c_tf / v_f,
                      a_ft / v_t, a_tf / v_f], dim=1)
    bv = torch.stack([-v2 * op.b_d - q, v * op.g_d + p / v,
                      -v2 * op.g_d + p, -v * op.b_d + q / v, p, q], dim=1)
    f_p = torch.where(op.th_free > 0, p - p_sched, theta)
    f_q = torch.where(op.v_free > 0, q - q_sched, v - op.v_set)
    return ev, bv, torch.cat([f_p, f_q], dim=1)


def sparse_matvec_plain(ev, bv, u, op: SparseOperands) -> Tensor:
    """S2's plain version: ``J·u`` over the pattern, ``[B, 2n]``."""
    n = op.n
    fi, ti = op.f_idx.long(), op.t_idx.long()
    rows = torch.cat([fi, ti])
    a_ft, a_tf, c_ft, c_tf, cv_ft, cv_tf, av_ft, av_tf = ev.unbind(1)
    h_d, n_d, j_d, l_d = bv[:, 0], bv[:, 1], bv[:, 2], bv[:, 3]
    uth, uv = u[:, :n], u[:, n:]
    uth_f, uth_t = uth[:, fi], uth[:, ti]
    uv_f, uv_t = uv[:, fi], uv[:, ti]
    p_vals = torch.cat([a_ft * uth_t + cv_ft * uv_t,
                        a_tf * uth_f + cv_tf * uv_f], dim=1)
    q_vals = torch.cat([-c_ft * uth_t + av_ft * uv_t,
                        -c_tf * uth_f + av_tf * uv_f], dim=1)
    yp = _seg(p_vals, rows, n) + h_d * uth + n_d * uv
    yq = _seg(q_vals, rows, n) + j_d * uth + l_d * uv
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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_lock = threading.Lock()
_lib = None
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _sparse_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("sparse")
            for suffix in _SUFFIX.values():
                sigs = {
                    "sparse_assemble": [_P] * 19 + [_I] * 3 + [_P],
                    "sparse_matvec": [_P] * 9 + [_I] * 3 + [_P],
                    "gmres_block_orth": [_P] * 3 + [_I] * 5 + [_P],
                    "gmres_lstsq": [_P] * 6 + [_I] * 3 + [_P],
                }
                for name, args in sigs.items():
                    fn = getattr(lib, f"{name}_{suffix}")
                    fn.argtypes = args
                    fn.restype = _I
            _lib = lib
        return _lib


def _want(like: Tensor, spec: Dict[str, Tuple[Tensor, torch.dtype, tuple]]):
    """Check device, dtype, shape and contiguity before a launch."""
    if like.dtype not in _SUFFIX:
        raise TypeError(f"kernels take float64 or float32, got {like.dtype}")
    for name, (t, dtype, shape) in spec.items():
        if t.device != like.device or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {dtype} on {like.device}, got {t.dtype} on "
                f"{t.device}"
            )
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {tuple(shape)} tensor, got "
                f"{tuple(t.shape)}"
            )


def _op_spec(op: SparseOperands, dtype) -> dict:
    n, m = op.n, op.m
    i32 = torch.int32
    spec = {"f_idx": (op.f_idx, i32, (m,)), "t_idx": (op.t_idx, i32, (m,)),
            "inc_ptr": (op.inc_ptr, i32, (n + 1,)),
            "inc_code": (op.inc_code, i32, (2 * m,)),
            "inc_nbr": (op.inc_nbr, i32, (2 * m,))}
    for name in ("yft_re", "yft_im", "ytf_re", "ytf_im"):
        spec[name] = (getattr(op, name), dtype, (m,))
    for name in ("g_d", "b_d", "th_free", "v_free", "v_set"):
        spec[name] = (getattr(op, name), dtype, (n,))
    return spec


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sparse_assemble(x, p_sched, q_sched,
                    op: SparseOperands) -> Tuple[Tensor, Tensor, Tensor]:
    """S1: the value fill and the masked mismatch at ``x [B, 2n]``.

    Returns ``(ev [B, 8, m], bv [B, 6, n], f [B, 2n])``."""
    if x.device.type == "cpu":
        return sparse_assemble_plain(x, p_sched, q_sched, op)
    n, m = op.n, op.m
    lanes = x.shape[0]
    spec = {"x": (x, x.dtype, (lanes, 2 * n)),
            "p_sched": (p_sched, x.dtype, (lanes, n)),
            "q_sched": (q_sched, x.dtype, (lanes, n))}
    spec.update(_op_spec(op, x.dtype))
    _want(x, spec)
    fn = getattr(_sparse_lib(), f"sparse_assemble_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        ev = torch.empty(lanes, 8, m, dtype=x.dtype, device=x.device)
        bv = torch.empty(lanes, 6, n, dtype=x.dtype, device=x.device)
        f = torch.empty(lanes, 2 * n, dtype=x.dtype, device=x.device)
        ptrs = (x, p_sched, q_sched, op.th_free, op.v_free, op.v_set,
                op.yft_re, op.yft_im, op.ytf_re, op.ytf_im, op.g_d, op.b_d,
                op.f_idx, op.t_idx, op.inc_ptr, op.inc_code, ev, bv, f)
        rc = fn(*(t.data_ptr() for t in ptrs), lanes, n, m, _stream(x))
    _raise_on(rc, "sparse_assemble")
    _count("sparse_assemble")
    return ev, bv, f


def sparse_matvec(ev, bv, u, op: SparseOperands) -> Tensor:
    """S2: ``J·u`` for ``u [B, 2n]`` over the value fill ``(ev, bv)``;
    pinned rows pass ``u`` through."""
    if u.device.type == "cpu":
        return sparse_matvec_plain(ev, bv, u, op)
    n, m = op.n, op.m
    lanes = u.shape[0]
    spec = {"u": (u, u.dtype, (lanes, 2 * n)),
            "ev": (ev, u.dtype, (lanes, 8, m)),
            "bv": (bv, u.dtype, (lanes, 6, n))}
    spec.update(_op_spec(op, u.dtype))
    _want(u, spec)
    fn = getattr(_sparse_lib(), f"sparse_matvec_{_SUFFIX[u.dtype]}")
    with torch.cuda.device(u.device):
        y = torch.empty_like(u)
        ptrs = (ev, bv, u, op.th_free, op.v_free, op.inc_ptr, op.inc_code,
                op.inc_nbr, y)
        rc = fn(*(t.data_ptr() for t in ptrs), lanes, n, m, _stream(u))
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
    lanes, nrows, nvec = v_basis.shape
    s = w_blk.shape[1]
    j0 = int(j0)
    if not (1 <= s <= MAX_BLOCK and 0 <= j0 and j0 + 1 + s <= nrows
            and nrows <= MAX_KRYLOV + 1):
        raise ValueError(
            f"unsupported block: s={s}, j0={j0}, {nrows} basis rows "
            f"(s <= {MAX_BLOCK}, mm <= {MAX_KRYLOV})"
        )
    _want(v_basis, {"v_basis": (v_basis, v_basis.dtype, (lanes, nrows, nvec)),
                    "valid": (valid, v_basis.dtype, (lanes, nrows)),
                    "w_blk": (w_blk, v_basis.dtype, (lanes, s, nvec))})
    fn = getattr(_sparse_lib(), f"gmres_block_orth_{_SUFFIX[v_basis.dtype]}")
    with torch.cuda.device(v_basis.device):
        rc = fn(v_basis.data_ptr(), valid.data_ptr(), w_blk.data_ptr(), lanes,
                nrows, s, nvec, j0, _stream(v_basis))
    _raise_on(rc, "gmres_block_orth")
    _count("gmres_block_orth")


def gmres_lstsq(v_basis, valid, w_store, z_store, beta) -> Tensor:
    """S4: the cycle's update ``x = Zᵀ y`` with ``y`` the SVD
    minimum-norm solution of ``min ‖β e₁ − (V·valid) Wᵀ y‖``."""
    if v_basis.device.type == "cpu":
        return gmres_lstsq_plain(v_basis, valid, w_store, z_store, beta)
    lanes, nrows, nvec = v_basis.shape
    mm = nrows - 1
    if not 1 <= mm <= MAX_KRYLOV:
        raise ValueError(f"unsupported Krylov dimension {mm} "
                         f"(1 <= mm <= {MAX_KRYLOV})")
    dt = v_basis.dtype
    _want(v_basis, {"v_basis": (v_basis, dt, (lanes, nrows, nvec)),
                    "valid": (valid, dt, (lanes, nrows)),
                    "w_store": (w_store, dt, (lanes, mm, nvec)),
                    "z_store": (z_store, dt, (lanes, mm, nvec)),
                    "beta": (beta, dt, (lanes,))})
    fn = getattr(_sparse_lib(), f"gmres_lstsq_{_SUFFIX[dt]}")
    with torch.cuda.device(v_basis.device):
        x = torch.empty(lanes, nvec, dtype=dt, device=v_basis.device)
        rc = fn(v_basis.data_ptr(), valid.data_ptr(), w_store.data_ptr(),
                z_store.data_ptr(), beta.data_ptr(), x.data_ptr(), lanes, mm,
                nvec, _stream(v_basis))
    _raise_on(rc, "gmres_lstsq")
    _count("gmres_lstsq")
    return x
