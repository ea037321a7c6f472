"""The one-card superstep (the reference's ``freedm_tpu/parallel``
without its mesh helpers and collectives: ROADMAP.md, item 16)."""

from freedm_tpu_torch.parallel.superstep import (  # noqa: F401
    FleetState,
    SuperstepOut,
    make_superstep,
)
