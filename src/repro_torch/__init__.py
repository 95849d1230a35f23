"""PyTorch + CUDA port of the Kerncraft reproduction (``repro``).

The JAX package ``repro`` stays the reference; this package imports
``torch``, numpy, sympy and yaml, and nothing of ``jax`` or ``repro``.
Its first slice is the paper's stencil case study on an NVIDIA H100:
trace a point function, model it (layer conditions → ECM/Roofline on
``machines/h100_sxm.yaml``), run it as a hand-written CUDA kernel, time
it, and hold the time against the prediction.  Its second slice is the
autotuner (``python -m repro_torch tune flash_attention -m H100``): rank
flash-attention block sizes with a closed-form model of the CUDA kernel,
measure the shortlist on the card, and derive calibration factors.
"""
