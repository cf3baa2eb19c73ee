"""The benchmark of ``multimodalgame_tpu_torch``, the PyTorch and CUDA port
of the referential game, on NVIDIA GPUs. ``python3 gamebench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell
of ``BENCHMARK.json``; see ``gamebench/run.py``."""
