"""The benchmark of the PyTorch/CUDA port (``repro_torch``): speculative
training under libDSE on one NVIDIA H100. Run a cell with
``python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; ``BENCHMARK.json`` at that root lists the cells."""
