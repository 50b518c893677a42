"""The dataset registry: the port of ``repro.data.registry``.

A ``DatasetEntry`` bundles what the protocol needs to build a
federation on a dataset by name:

  make        (n=None, seed=None, test_frac=0.2)
              -> (x_train, y_train, x_test, y_test)
  n_classes   label cardinality (binary -> F1 average="binary")
  arch        repro_torch.configs model-config name for the PaperMLP
              built on this dataset
  partition   how features are dealt to clients: "image_rows" (Fig. 2
              row round-robin), "random", "round_robin", or a callable
              (n_features, n_clients, seed) -> list of per-client
              sorted feature-index arrays

The four paper datasets are pre-registered with ``make`` delegating to
``repro_torch.data.synthetic.make_dataset``, a verbatim copy of the JAX
package's generators, so the draws are bit-identical to the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Union

from repro_torch.data import synthetic as SD
from repro_torch.registry import Registry

PARTITION_KINDS = ("image_rows", "random", "round_robin")


@dataclass(frozen=True)
class DatasetEntry:
    name: str
    make: Callable          # (n=None, seed=None, test_frac=0.2) -> 4-tuple
    n_classes: int
    arch: str               # repro_torch.configs config name
    partition: Union[str, Callable] = "round_robin"


DATASETS = Registry("dataset")


def register_dataset(name, loader=None, *, n_classes, arch,
                     partition="round_robin", make=None,
                     overwrite=False) -> DatasetEntry:
    """Register a dataset by name.

    Provide EITHER ``loader`` -- ``(n=None, seed=None) -> (x, y)`` with
    x [N, F] float32 and y [N] int labels, wrapped in the standard
    head-is-test split -- or ``make`` for full control of the
    train/test split (same signature/return as ``DatasetEntry.make``).
    ``arch`` names the model config whose ``in_features`` matches the
    feature count.
    """
    if (loader is None) == (make is None):
        raise ValueError("register_dataset needs exactly one of "
                         "loader= or make=")
    if isinstance(partition, str) and partition not in PARTITION_KINDS:
        raise ValueError(f"unknown partition kind {partition!r}; pick "
                         f"one of {PARTITION_KINDS} or pass a callable")
    if make is None:
        make = partial(_split, loader)
    entry = DatasetEntry(name=name, make=make, n_classes=int(n_classes),
                         arch=arch, partition=partition)
    return DATASETS.register(name, entry, overwrite=overwrite)


def _split(loader, n=None, seed=None, test_frac=0.2):
    """Wrap a raw (x, y) loader in the train/test split rule
    (``synthetic.split_train_test``)."""
    kw = {}
    if n is not None:
        kw["n"] = n
    if seed is not None:
        kw["seed"] = seed
    return SD.split_train_test(*loader(**kw), test_frac=test_frac)


def get_dataset(name) -> DatasetEntry:
    return DATASETS.get(name)


def dataset_names() -> list:
    return DATASETS.names()


def make_dataset(name, n=None, seed=None, test_frac=0.2):
    """Registry-routed (x_train, y_train, x_test, y_test), numpy."""
    return get_dataset(name).make(n, seed=seed, test_frac=test_frac)


def make_dataset_stack(name, seeds, n=None, test_frac=0.2):
    """Per-seed draws stacked on a leading seed axis (rectangular), for
    seed-stacked sweeps -- the registry-routed twin of
    ``synthetic.make_dataset_stack`` (the same stacking helper): seed
    s's slice is ``make_dataset(name, n, seed=s)``."""
    entry = get_dataset(name)

    def mk(n, seed=None, test_frac=0.2):
        return entry.make(n, seed=seed, test_frac=test_frac)
    return SD.stack_splits(mk, seeds, n=n, test_frac=test_frac)


register_dataset("mnist", make=partial(SD.make_dataset, "mnist"),
                 n_classes=10, arch="paper-mlp-mnist",
                 partition="image_rows")
register_dataset("fmnist", make=partial(SD.make_dataset, "fmnist"),
                 n_classes=10, arch="paper-mlp-fmnist",
                 partition="image_rows")
register_dataset("titanic", make=partial(SD.make_dataset, "titanic"),
                 n_classes=2, arch="paper-mlp-titanic",
                 partition="random")
register_dataset("bank", make=partial(SD.make_dataset, "bank"),
                 n_classes=2, arch="paper-mlp-bank",
                 partition="round_robin")
