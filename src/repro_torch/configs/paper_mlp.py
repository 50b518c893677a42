"""The paper's own models: 3-hidden-layer MLPs (10 neurons each) for
MNIST / FMNIST (10-class) and Titanic / Bank Marketing (binary).
Section III-IV of De-VertiFL.  The port's counterpart of
``repro.configs.paper_mlp``; the LM configs are not ported."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.registry import Registry

CONFIGS = Registry("model config")


@dataclass(frozen=True)
class MLPConfig:
    name: str
    in_features: int        # the JAX config's vocab_size
    n_classes: int
    hidden: int = 10        # d_model
    n_hidden: int = 3       # num_layers
    source: str = "De-VertiFL section IV"


def _mlp(name, in_features, n_classes, hidden=10, n_hidden=3):
    cfg = MLPConfig(name, in_features, n_classes, hidden, n_hidden)
    return CONFIGS.register(name, cfg)


MNIST = _mlp("paper-mlp-mnist", 784, 10)
FMNIST = _mlp("paper-mlp-fmnist", 784, 10)
TITANIC = _mlp("paper-mlp-titanic", 9, 2)
BANK = _mlp("paper-mlp-bank", 51, 2)


def get_config(name) -> MLPConfig:
    return CONFIGS.get(name)
