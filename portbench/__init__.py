"""The benchmark of the PyTorch/CUDA port (``flink_ml_tpu_torch``).

Run one cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``BENCHMARK.json``
there names the cells. Everything a cell needs is found by name:
``configs/<config>.json`` (the stage, its params, the input generator, the
limits of the check), ``traffic/<traffic>.json`` (the mix's parameters,
naming its ``loops/<loop>.py``, how calls arrive in the window, and its
``calls/<call>.py``, what one call does), ``metrics/<metric>.py`` (one
reader a metric), ``reference/<algorithm>.py`` (the plain reference and
its comparison) and ``cost/<algorithm>.py`` (a call's bytes and
operations).
"""
