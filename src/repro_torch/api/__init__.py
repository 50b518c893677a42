"""repro_torch.api -- the one front door to De-VertiFL experiments on
the GPU: the port of ``repro.api``.

Declare WHAT to run as a frozen, hashable :class:`ExperimentSpec`
(validated eagerly against the dataset / mode / first-layer
registries; its ``spec_hash`` is the reference's), then :func:`build`
it into a :class:`Session` and run::

    from repro_torch.api import ExperimentSpec, build

    spec = ExperimentSpec(dataset="mnist", mode="devertifl",
                          n_clients=5, rounds=5)
    result = build(spec).run()          # -> RunResult, on CUDA
    print(result.metrics, result.spec_hash)

``build(spec, device="cpu")`` runs on the CPU.  Extend an axis through
the registries: :func:`register_dataset`, :func:`register_mode`,
:func:`register_first_layer`.  A spec grid runs one lane batch a
(dataset, mode) on the sweep engine (``repro_torch.core.sweep``)::

    grid = run_grid(spec_grid(datasets=("titanic",), modes=("devertifl",),
                              client_counts=(2, 3), seeds=(0, 1)))

and takes ``device="cpu"`` as ``build`` does.  A spec's ``schedule``,
``fault``, ``transform`` and ``obs`` run the round engine's layers
(``repro_torch.schedule``, ``.faults``, ``.wire``, ``.obs``).  A trained
federated Session serves requests whose features arrive split across
clients (``Session.server``/``serve``, ``repro_torch.serving``)::

    report = sess.serve([ServeRequest(uid=i, slices=split_features(
        sess.federation.layout, row)) for i, row in enumerate(rows)])
"""
from repro_torch.api.spec import ExperimentSpec, HASH_EXCLUDE  # noqa: F401
from repro_torch.api.modes import (  # noqa: F401
    ModeEntry, get_mode, mode_names, register_mode,
)
from repro_torch.api.session import (  # noqa: F401
    RESULT_SCHEMA_VERSION, RunResult, Session, build, git_sha, run_grid,
    spec_grid, sweep_config_for_specs,
)
from repro_torch.core.protocol import register_first_layer  # noqa: F401
from repro_torch.data.registry import (  # noqa: F401
    DatasetEntry, dataset_names, get_dataset, register_dataset,
)
from repro_torch.schedule import (  # noqa: F401
    Schedule, get_schedule, register_schedule, schedule_names,
)
from repro_torch.serving.federated import (  # noqa: F401
    ExchangeCache, FederatedServer, ServeReport, ServeRequest,
    split_features,
)


def first_layer_names() -> list:
    """Registered first-layer lane names."""
    from repro_torch.core.protocol import FIRST_LAYERS
    return FIRST_LAYERS.names()
