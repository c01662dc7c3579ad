"""The benchmark of the PyTorch and CUDA port (``jaeger_tpu_torch``):
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``benchmark/README.md``."""
