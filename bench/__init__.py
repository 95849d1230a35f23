"""The benchmark of the PyTorch and CUDA port (``repro_torch``): training
steps on one H100, driven by ``bench/run.py``; see ``bench/README.md``."""
