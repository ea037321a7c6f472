"""Hand-written Hopper kernels of the power-flow, screening, ladder and
QSTS paths and the serving cache.

- K1 ``newton_assemble``, K2 ``power_injections`` and K3
  ``newton_update`` — CUDA C++ (``csrc/newton.cu``);
- S1-S4, the sparse Newton backend's kernels — CUDA C++
  (``csrc/sparse.cu``);
- C1 ``delta_program``, the serving cache's delta program — CUDA C++
  (``csrc/cache.cu``);
- N1 ``smw_sweep`` and D1 ``dc_screen``, the N-1 and DC screens' kernels
  — CUDA C++ (``csrc/screen.cu``);
- L1 ``ladder_solve`` and L2 ``ladder_vjp``, the radial ladder solve and
  its adjoint — CUDA C++ (``csrc/ladder.cu``);
- A1 ``agent_step``, Q1 ``qsts_bus_reduce`` and Q2 ``qsts_feeder_reduce``,
  the QSTS agent step and streaming reductions — CUDA C++
  (``csrc/qsts.cu``).

Each source is built by :mod:`.build` and bound with ctypes.
:mod:`.newton_kernels`, :mod:`.sparse_kernels`, :mod:`.cache_kernels`,
:mod:`.screen_kernels`, :mod:`.ladder_kernels` and :mod:`.qsts_kernels`
hold the wrappers, their plain PyTorch versions and the launch counters.
"""
