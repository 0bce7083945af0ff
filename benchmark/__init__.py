"""The benchmark of burn_raymarching_tpu_torch: run one cell with
``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (README of the folder:
``benchmark/run.py``'s docstring)."""
