"""The benchmark's plain reference: what the port must compute, written
again in plain PyTorch (float32, TF32 off) and NumPy.

Nothing here imports ``jaeger_tpu_torch`` or the JAX package, and nothing
here takes what the program made: the reference reads the inputs the
benchmark made itself (the assembly, the CSV rows, the seeded weights) and
works the windows, tokens, forward, reductions and training steps out
again. The program's outputs are read only by :mod:`.judge`, to judge them.
"""
