from lr2ppo_torch.data.movienet import MovieNetDataset  # noqa: F401
from lr2ppo_torch.data.pipeline import (  # noqa: F401
    EvalLoader,
    Loader,
    ProcessLoader,
)
