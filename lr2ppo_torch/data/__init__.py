from lr2ppo_torch.data.movienet import MovieNetDataset  # noqa: F401
from lr2ppo_torch.data.letor import (  # noqa: F401
    LetorQueries,
    LTRPointwiseDataset,
    LTRRewardDataset,
    LTRPPODataset,
    parse_svmlight_file,
    write_tsv,
    make_qids_disjoint,
    group_queries,
)
from lr2ppo_torch.data.pipeline import (  # noqa: F401
    EvalLoader,
    Loader,
    ProcessLoader,
)
