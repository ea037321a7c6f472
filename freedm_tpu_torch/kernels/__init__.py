"""Hand-written Hopper kernels of the dense Newton power-flow path.

- K1 ``newton_assemble`` and K2 ``power_injections`` — CUDA C++
  (``csrc/newton.cu``), built by :mod:`.build` and bound with ctypes;
- K3 ``newton_update`` — Triton (:mod:`.newton_update_triton`).

:mod:`.newton_kernels` holds the wrappers, their plain PyTorch versions
and the launch counters.
"""
