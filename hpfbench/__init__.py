"""Benchmark of the PyTorch/CUDA port (`hgaprec_tpu_torch`).

`python3 hpfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on an NVIDIA GPU
and prints one JSON result line. Each configuration, traffic mix,
per-layer metric, generator, reference and set of limits is a file of
its own here, found by the name that `BENCHMARK.json` or a configuration
gives (`manifest.py`).
"""
