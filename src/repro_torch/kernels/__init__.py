"""The port's stencil kernels: traced point functions, hand-written CUDA
kernels for Hopper (``../csrc``) and their plain PyTorch versions.
Importing builds nothing; a kernel is compiled at its first launch."""
