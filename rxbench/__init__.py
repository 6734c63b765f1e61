"""The benchmark of rxtpu_torch, the PyTorch and CUDA port of rxtpu, on one
NVIDIA H100: ``python -m rxbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``."""
