"""CPU tests of the benchmark: `python -m pytest avbench/tests -q`."""
