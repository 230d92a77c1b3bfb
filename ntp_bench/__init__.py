"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell once (``python3 -m ntp_bench.run``).  See ``run.py``."""
