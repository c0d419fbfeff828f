"""The benchmark of rav1d_tpu_torch, the AV1 decoder on PyTorch and CUDA.

`python -m avbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` decodes a seeded synthetic stream through the port's
`Decoder` on the first CUDA card for `--seconds`, checks the pictures it
returned against a frozen copy of the decoder's numpy host path
(`avbench/reference/`), and prints one JSON result line. The cells, their
configurations, traffic mixes and metrics are named in the repository's
`BENCHMARK.json`; each lives in a file of its own here
(`configs/<name>.json`, `traffic/<name>.json`, `metrics/<name>.py`).
"""
