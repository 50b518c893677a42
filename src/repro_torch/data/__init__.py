from repro_torch.data.synthetic import (  # noqa: F401
    make_dataset, synthetic_mnist, synthetic_fmnist, synthetic_titanic,
    synthetic_bank,
)
from repro_torch.data.vertical import (  # noqa: F401
    feature_mask, random_features, round_robin_features, round_robin_rows,
)
from repro_torch.data.registry import (  # noqa: F401
    DatasetEntry, dataset_names, get_dataset, register_dataset,
)
from repro_torch.data.lm import MarkovLM, markov_lm_batches  # noqa: F401
