"""Hand-written Hopper kernels of the power-flow path and the serving cache.

- K1 ``newton_assemble``, K2 ``power_injections`` and K3
  ``newton_update`` — CUDA C++ (``csrc/newton.cu``);
- S1-S4, the sparse Newton backend's kernels — CUDA C++
  (``csrc/sparse.cu``);
- C1 ``delta_mismatch``, the serving cache's delta sweep — CUDA C++
  (``csrc/cache.cu``).

Each source is built by :mod:`.build` and bound with ctypes.
:mod:`.newton_kernels`, :mod:`.sparse_kernels` and :mod:`.cache_kernels`
hold the wrappers, their plain PyTorch versions and the launch counters.
"""
