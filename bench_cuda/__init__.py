"""The benchmark of ``snn_automotive_object_detection_tpu_torch``, the
PyTorch and CUDA port, on NVIDIA H100s.

``python -m bench_cuda --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` makes one run of one cell of ``BENCHMARK.json`` (``harness.py``)
and prints its result as the last line of standard output. The yardstick
lives here, apart from the program: the weights' and the traffic's
generators (``weights.py``, ``harness.eval_batches``,
``train.train_batches``), the plain reference (``reference/``), the
comparisons that decide ``correct`` (``judge.py``; ``train.py`` for a
training cell, on one card or on ranks that ``ranks.py`` starts), the
dense FLOP count (``flops.py``), the peaks and K1's least time
(``roofline.py``), the trace's reduction (``profile.py``) and one reader
per per-layer metric (``metrics/``). It imports the port and torch, never
JAX, the JAX package, ``bench_torch`` or ``chip_smoke``.
"""
