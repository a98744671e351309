"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python3 -m gvr_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the card and prints one
JSON line. See README.md beside this file.
"""
