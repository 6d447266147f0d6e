from lr2ppo_torch.utils.guards import (  # noqa: F401
    NonFiniteLossError,
    StepTimer,
    TraceWindow,
    check_finite,
    maybe_trace,
)
from lr2ppo_torch.utils.logging import MetricLogger, init_logger  # noqa: F401
