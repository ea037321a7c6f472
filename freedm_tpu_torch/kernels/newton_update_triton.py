"""K3 ``newton_update``: the per-lane masked Newton update, in Triton.

Replaces the per-lane ``select`` that XLA fuses out of the
``lax.while_loop`` under ``vmap`` in ``freedm_tpu/pf/newton.py:325-336``.
One program per lane walks the lane's ``[2n]`` row in blocks:

    err_new = max |f · free|          (NaN if any element is NaN)
    if active:  x += dx;  it += 1;  err = err_new
    active = (it < max_iter) & (err >= tol)

``err`` is the mismatch of the point the step started from (the
reference's pre-update carry), and ``err >= tol`` is written as the
reference writes it, so a NaN lane stops.  Bound on an H100 SXM: bytes —
it reads x, dx, f (and the shared mask) and writes x, about
``4 · 2n · 8`` bytes a lane in float64 (8 MB at n = 2000, B = 64, a
couple of microseconds at 3.35 TB/s), so at these sizes its launch costs
more than its traffic.

``triton`` is imported inside :func:`launch`, never at module import:
the CPU tests import this module where there is no ``triton``.
"""

from __future__ import annotations

import threading

import torch

from freedm_tpu_torch.kernels import build

BLOCK = 1024

_kernel = None
_kernel_lock = threading.Lock()


def _get_kernel():
    # `triton`/`tl` become module globals here: Triton resolves the names
    # a kernel body uses through the function's globals.
    global _kernel, triton, tl
    with _kernel_lock:
        if _kernel is not None:
            return _kernel
        build.triton_cache_dir()
        import triton
        import triton.language as tl

        @triton.jit
        def newton_update_kernel(x_ptr, dx_ptr, f_ptr, free_ptr, it_ptr,
                                 err_ptr, active_ptr, tol_ptr, m, max_iter,
                                 BLOCK: tl.constexpr):
            lane = tl.program_id(0)
            row = lane.to(tl.int64) * m
            act = tl.load(active_ptr + lane) != 0
            # The max runs in the state's dtype, as the plain version's.
            worst = tl.zeros([BLOCK], dtype=f_ptr.dtype.element_ty)
            nans = tl.zeros([BLOCK], dtype=tl.int32)
            for start in range(0, m, BLOCK):
                offs = start + tl.arange(0, BLOCK)
                mask = offs < m
                fv = tl.load(f_ptr + row + offs, mask=mask, other=0.0)
                fr = tl.load(free_ptr + offs, mask=mask, other=0.0)
                a = tl.abs(fv * fr)
                nans = tl.maximum(nans, (a != a).to(tl.int32))
                worst = tl.maximum(worst, a)
                upd = mask & act
                xv = tl.load(x_ptr + row + offs, mask=upd, other=0.0)
                dv = tl.load(dx_ptr + row + offs, mask=upd, other=0.0)
                tl.store(x_ptr + row + offs, xv + dv, mask=upd)
            err_new = tl.max(worst, axis=0)
            err_new = tl.where(tl.max(nans, axis=0) > 0, float("nan"), err_new)
            it = tl.load(it_ptr + lane)
            err = tl.load(err_ptr + lane)
            it = tl.where(act, it + 1, it)
            err = tl.where(act, err_new, err)
            tol = tl.load(tol_ptr)
            tl.store(it_ptr + lane, it)
            tl.store(err_ptr + lane, err)
            tl.store(active_ptr + lane,
                     ((it < max_iter) & (err >= tol)).to(tl.int8))

        _kernel = newton_update_kernel
        return _kernel


def launch(x: torch.Tensor, dx: torch.Tensor, f: torch.Tensor,
           free: torch.Tensor, it: torch.Tensor, err: torch.Tensor,
           active: torch.Tensor, max_iter: int, tol: torch.Tensor) -> None:
    """Launch K3 on the current stream; updates x, it, err and active in
    place.  Inputs are checked by the caller
    (:func:`freedm_tpu_torch.kernels.newton_kernels.newton_update`)."""
    kernel = _get_kernel()
    lanes, m = x.shape
    kernel[(lanes,)](x, dx, f, free, it, err, active.view(torch.int8), tol,
                     m, int(max_iter), BLOCK=BLOCK, num_warps=4)
