"""PyTorch and CUDA port of the olavm_tpu STARK prover.

The port imports torch and never jax, and nothing of the olavm_tpu package:
every host module it needs (field, ISA, assembler, interpreter, runtime,
tables, STARK base, host libraries in native/) is carried here as a copy at
the same relative path, each naming its original in its docstring. The
hand-written Hopper kernels are in csrc/, built and loaded by kernels.py.
"""
