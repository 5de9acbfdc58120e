"""The benchmark of the PyTorch port (``speech_tranformer_pytorch_tpu_torch``).

One run drives one cell of ``BENCHMARK.json`` once on one H100:
``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
Everything the harness measures with is here: the traffic generator, the
plain reference under ``reference/``, the operation and byte counts under
``work/`` and one reader per metric under ``metrics/``. From the port it
takes only the code under test and its counters.
"""
