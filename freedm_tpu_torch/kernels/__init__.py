"""Hand-written Hopper kernels of the dense Newton power-flow path.

- K1 ``newton_assemble``, K2 ``power_injections`` and K3
  ``newton_update`` — CUDA C++ (``csrc/newton.cu``), built by
  :mod:`.build` and bound with ctypes.

:mod:`.newton_kernels` holds the wrappers, their plain PyTorch versions
and the launch counters.
"""
