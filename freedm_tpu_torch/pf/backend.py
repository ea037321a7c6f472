"""Backend and precision resolution for the power-flow engines.

Ports ``BACKENDS``/``SPARSE_AUTO_MIN_BUSES``/``resolve_backend``
(``freedm_tpu/pf/sparse.py:105-125``) and ``PF_PRECISIONS``/
``resolve_precision`` (``freedm_tpu/pf/krylov.py:117-132``).  Only the
dense Jacobian backend is ported so far: asking for ``"sparse"``, or an
``"auto"`` that resolves to it, raises :class:`BackendNotPorted` — it
never solves dense in its place.
"""

from __future__ import annotations

#: ``backend="auto"`` crossover: dense below this many buses, sparse at
#: and above it (the reference's value).
SPARSE_AUTO_MIN_BUSES = 512

#: The ``--pf-backend`` vocabulary.
BACKENDS = ("dense", "sparse", "auto")

#: The ``--pf-precision`` vocabulary.
PF_PRECISIONS = ("f64", "mixed", "auto")


class BackendNotPorted(NotImplementedError):
    """The requested power-flow backend has no port yet."""


def resolve_backend(backend: str, n_bus: int) -> str:
    """Resolve a ``--pf-backend`` value to ``"dense"`` for a case of
    ``n_bus`` buses: a typed ``ValueError`` on unknown values and
    :class:`BackendNotPorted` where the answer would be ``"sparse"``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown pf backend {backend!r} (have: {', '.join(BACKENDS)})"
        )
    why = "requested"
    if backend == "auto":
        backend = "sparse" if n_bus >= SPARSE_AUTO_MIN_BUSES else "dense"
        why = f"what 'auto' picks at {n_bus} >= {SPARSE_AUTO_MIN_BUSES} buses"
    if backend == "sparse":
        raise BackendNotPorted(
            f"the sparse power-flow backend ({why}) is not ported yet "
            f"(ROADMAP.md, module queue items 4-5: sparse Newton with "
            f"Krylov and FDLF); use backend='dense'"
        )
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
