from lr2ppo_torch.utils.guards import (  # noqa: F401
    NonFiniteLossError,
    TraceWindow,
    check_finite,
    count,
    counters,
    recording,
    span,
)
from lr2ppo_torch.utils.logging import MetricLogger, init_logger  # noqa: F401
