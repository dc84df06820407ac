"""trackbench: the benchmark of shasta_tpu_torch on one CUDA card.

    python3 -m trackbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (configs/<name>.json) and a
traffic mix (traffic/<name>.json); the mix names its driver
(drivers/<name>.py), and each per-layer metric has its reader
(metrics/<name>.py). Nothing here imports jax or the JAX package, and
reference/ imports nothing of the port.
"""
