"""The benchmark of the PyTorch/CUDA port: ``python3 perfbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
