"""Power-flow solvers (dense and sparse Newton-Raphson, backend
resolution, the radial ladder), N-1 and DC screening and topology sweeps.

The public names of the reference's ``freedm_tpu/pf/__init__.py`` that
the port has so far.
"""

from freedm_tpu_torch.pf.backend import (  # noqa: F401
    BACKENDS,
    SPARSE_AUTO_MIN_BUSES,
    resolve_backend,
)
from freedm_tpu_torch.pf.dc import make_dc_solver  # noqa: F401
from freedm_tpu_torch.pf.ladder import (  # noqa: F401
    LadderResult,
    branch_power_kva,
    load_power_kva,
    make_ladder_solver,
    substation_power_kva,
    total_loss_kw,
    v_polar,
)
from freedm_tpu_torch.pf.mfree import make_injection_fn  # noqa: F401
from freedm_tpu_torch.pf.n1 import (  # noqa: F401
    N1Prefiltered,
    make_n1_screen,
    secure_outages,
)
from freedm_tpu_torch.pf.newton import (  # noqa: F401
    NewtonResult,
    branch_flows,
    make_newton_solver,
)
from freedm_tpu_torch.pf.sparse import (  # noqa: F401
    jacobian_pattern,
    make_sparse_newton_solver,
)
from freedm_tpu_torch.pf.topo import (  # noqa: F401
    TopoSweepSpec,
    enumerate_variants,
    make_ac_verifier,
    make_radiality_check,
    make_topk_merge,
    make_topo_screen,
    neighborhood_variants,
    run_topo_sweep,
    screen_chunk,
)
