"""The port's benchmark: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` (see run.py), its tests under
``benchmark/tests`` (``python -m pytest benchmark/tests``)."""
