"""The benchmark of the PyTorch and CUDA port (``feature_detector_tpu_torch``).

One run measures one cell of ``BENCHMARK.json``:

    python3 -m bench_cuda.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a configuration in ``configs/<config>.json``,
a traffic mix in ``traffic/<mix>.json`` (parameters that ``frames.py``
reads), a per-layer metric in ``metrics/<metric>.py``, the code that drives
the port for a configuration in ``pipelines/<pipeline>.py`` and its plain
reference in ``reference/``.  The yardstick (traffic, peaks, bounds, FLOP
counts, references and the comparison that decides ``correct``) lives here
and imports nothing of the JAX package; only ``pipelines/`` imports the port.
"""
