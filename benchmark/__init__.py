"""The benchmark of tssplat_torch, the PyTorch and CUDA port.

One command runs one cell once and prints one JSON line:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells are read from ``BENCHMARK.json`` at the root of the checkout; a
cell's configuration from ``benchmark/configs/<config>.yaml``, its traffic
from ``benchmark/traffic/<traffic>.yaml``, its correctness limits from
``benchmark/limits/<cell>.yaml``, each per-layer metric from
``benchmark/metrics/<metric>.py``, and the configuration's inputs writer
and plain reference from ``benchmark/inputs/<name>.py`` and
``benchmark/reference/<name>.py`` (``benchmark/manifest.py``). Nothing
here imports JAX or the JAX package; ``benchmark/inputs`` and
``benchmark/reference`` import nothing of the port.
"""
