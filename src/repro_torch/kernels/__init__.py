"""The port's kernels: the stencils' traced point functions, the
hand-written CUDA kernels for Hopper (``../csrc``: the 7-point and
long-range stencils and flash attention) and their plain PyTorch versions.
Importing builds nothing; a kernel is compiled at its first launch."""
