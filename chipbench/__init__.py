"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``run.py`` runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line.  Every configuration, traffic mix,
metric reader and set of correctness limits is a file of its own, found by
the name ``BENCHMARK.json`` gives it; ``reference/`` holds the plain fp32
references that decide ``correct``.  Nothing here imports ``jax`` or the JAX
package ``repro``.
"""
