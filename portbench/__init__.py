"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the checkout's
root is the manifest, and ``manifest`` finds each cell's, configuration's,
traffic mix's and metric's files by name.  Nothing here imports JAX or
the JAX package.
"""
