"""Transport: the collective verbs over a rank mesh."""

from rocnrdma_tpu_torch.transport.api import (  # noqa: F401
    ALGOS,
    SCHEDULES,
    Transport,
    supports,
)
