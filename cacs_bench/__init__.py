"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an
NVIDIA H100: ``python3 cacs_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See README.md."""
