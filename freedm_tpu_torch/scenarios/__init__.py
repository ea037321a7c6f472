"""Batched quasi-static time-series (QSTS) studies on the card.

Port of ``freedm_tpu/scenarios``: seeded deterministic profile generators
(:mod:`.profiles`), grid-edge agent populations (:mod:`.agents`), the
chunked runner with warm starts, streaming reductions and chunk-boundary
checkpoints (:mod:`.engine`), and the async jobs layer the serving front
end exposes as ``POST /v1/qsts`` / ``GET /v1/jobs/<id>`` (:mod:`.jobs`).
"""

from freedm_tpu_torch.scenarios.engine import (  # noqa: F401
    QstsEngine,
    StudyCancelled,
    StudySpec,
    run_study,
)
from freedm_tpu_torch.scenarios.jobs import (  # noqa: F401
    JobManager,
    parse_job_request,
)
from freedm_tpu_torch.scenarios.profiles import (  # noqa: F401
    PROFILE_KINDS,
    ProfileSet,
    ProfileSpec,
)
