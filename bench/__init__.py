"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

Run a cell with ``python -m bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``README.md``
says how the pieces are found by name.
"""
