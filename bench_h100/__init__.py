"""The benchmark of the PyTorch and CUDA port (aiko_services_tpu_torch)
on NVIDIA H100 cards.  `python3 bench_h100/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` runs one cell; see README.md."""
