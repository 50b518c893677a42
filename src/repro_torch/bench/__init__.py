"""The port's twins of the JAX package's paper benchmarks:
``table2`` (Table II) and ``figures`` (Figs. 3-7).  They build the same
specs as ``benchmarks/table2.py`` and ``benchmarks/figures.py``, run
them through ``repro_torch.api``, and write their JSON under
``build/torch_results/`` unless told where (never
``benchmarks/results/``, the reference's record)."""
from pathlib import Path

# build/torch_results/ of this checkout
RESULTS = Path(__file__).resolve().parents[3] / "build" / "torch_results"
