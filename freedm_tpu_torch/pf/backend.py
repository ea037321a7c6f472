"""Backend and precision resolution for the power-flow engines.

Ports ``BACKENDS``/``SPARSE_AUTO_MIN_BUSES``/``resolve_backend``
(``freedm_tpu/pf/sparse.py:105-120``) and ``PF_PRECISIONS``/
``resolve_precision`` (``freedm_tpu/pf/krylov.py:117-132``).
"""

from __future__ import annotations

#: ``backend="auto"`` crossover: dense below this many buses, sparse at
#: and above it (the reference's value).
SPARSE_AUTO_MIN_BUSES = 512

#: The ``--pf-backend`` vocabulary.
BACKENDS = ("dense", "sparse", "auto")

#: The ``--pf-precision`` vocabulary.
PF_PRECISIONS = ("f64", "mixed", "auto")


def resolve_backend(backend: str, n_bus: int) -> str:
    """Resolve a ``--pf-backend`` value to ``"dense"`` or ``"sparse"``
    for a case of ``n_bus`` buses (typed ``ValueError`` on unknown
    values)."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown pf backend {backend!r} (have: {', '.join(BACKENDS)})"
        )
    if backend == "auto":
        return "sparse" if n_bus >= SPARSE_AUTO_MIN_BUSES else "dense"
    return backend


def resolve_precision(precision: str, platform: str) -> str:
    """Resolve a ``--pf-precision`` value to ``"f64"`` or ``"mixed"``
    (typed ``ValueError`` on unknown values).  ``platform`` is the
    reference's backend name (``"gpu"``/``"cpu"``,
    :func:`freedm_tpu_torch.device.platform_name`): ``"auto"`` picks
    ``"mixed"`` on ``gpu`` and ``"f64"`` on ``cpu``."""
    if precision not in PF_PRECISIONS:
        raise ValueError(
            f"unknown pf precision {precision!r} "
            f"(have: {', '.join(PF_PRECISIONS)})"
        )
    if precision == "auto":
        return "mixed" if platform in ("tpu", "gpu") else "f64"
    return precision
