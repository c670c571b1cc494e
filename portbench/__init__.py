"""The benchmark of the PyTorch port (``vnet_tpu_torch``) on NVIDIA cards.

One run is one cell of ``BENCHMARK.json`` (a configuration under one
traffic mix)::

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``portbench/README.md`` says how a cell, a configuration or a metric is
added as files. Nothing under ``portbench/`` imports JAX or the JAX
package; ``reference/`` and ``yardstick/`` import nothing of the port.
"""
