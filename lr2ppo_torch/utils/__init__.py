from lr2ppo_torch.utils.guards import (  # noqa: F401
    NonFiniteLossError,
    check_finite,
)
from lr2ppo_torch.utils.logging import MetricLogger, init_logger  # noqa: F401
