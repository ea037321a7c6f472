"""Hand-written Hopper kernels of the power-flow, screening, ladder, QSTS,
topology-sweep and DGI paths and the serving cache.

- K1 ``newton_assemble``, K2 ``power_injections`` and K3
  ``newton_update`` — CUDA C++ (``csrc/newton.cu``);
- S1-S4, the sparse Newton backend's kernels — CUDA C++
  (``csrc/sparse.cu``);
- C1 ``delta_program``, the serving cache's delta program — CUDA C++
  (``csrc/cache.cu``);
- N1 ``smw_screen`` (a whole SMW N-1 screen, its triangular solves on
  the B′/B″ LU pair included, in one launch) and D1 ``dc_screen``, the
  N-1 and DC screens' kernels — CUDA C++ (``csrc/screen.cu``);
- L1 ``ladder_solve`` and L2 ``ladder_vjp``, the radial ladder solve and
  its adjoint, and L4 ``ladder_doubling``, its pointer-jumping form —
  CUDA C++ (``csrc/ladder.cu``); L3 ``ladder_dense``, its form on the
  subtree matrix's nonzero blocks — CUDA C++ (``csrc/ladder_dense.cu``);
- A1 ``agent_step``, Q1 ``qsts_bus_reduce`` and Q2 ``qsts_feeder_reduce``,
  the QSTS agent step and streaming reductions — CUDA C++
  (``csrc/qsts.cu``);
- T1 ``topo_radiality`` and T2 ``topo_screen``, the topology sweep's
  connectivity check and rank-r SMW screen — CUDA C++ (``csrc/topo.cu``);
- Y1 ``ybus_stamp``, F1 ``fdlf_half_step``, J1 ``residual_jvp`` and I1
  ``cim_iterate``, the per-lane Ybus stamp, the fast-decoupled
  half-step, the residual JVP of the matrix-free solver and the
  three-phase CIM iteration — CUDA C++ (``csrc/solvers.cu``);
- G1 ``form_groups``, R1 ``reach_closure`` and B1 ``lb_rounds``, the DGI
  round's group formation and election, FID-gated reachability and draft
  auction (every round of a run in one launch) — CUDA C++
  (``csrc/dgi.cu``).

K2 (one Ybus), F1 (one Ybus, 4 lanes or more) and I1 share one tiled
complex product, ``csrc/row_product.cuh`` (float64 on the tensor cores,
float32 on the CUDA cores; its K slices from
:func:`.newton_kernels.product_splits`).

Each source is built by :mod:`.build` and bound with ctypes.
:mod:`.newton_kernels`, :mod:`.sparse_kernels`, :mod:`.cache_kernels`,
:mod:`.screen_kernels`, :mod:`.ladder_kernels`, :mod:`.qsts_kernels`,
:mod:`.topo_kernels`, :mod:`.solver_kernels` and :mod:`.dgi_kernels` hold
the wrappers, their plain PyTorch versions and the launch counters.
"""
