"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell a
run, ``python3 perfbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``; the cells, metrics and bounds are in
``BENCHMARK.json`` at the root of the checkout."""
