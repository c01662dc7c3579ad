"""jaeger_tpu_torch: the PyTorch/CUDA port of jaeger_tpu for NVIDIA Hopper.

The JAX package ``jaeger_tpu`` is the reference; this package imports
neither JAX nor anything of ``jaeger_tpu``. Its entry points run on a
CUDA device unless the caller passes ``device="cpu"``.
"""
