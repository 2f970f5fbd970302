"""Hand-written Hopper kernels: sources in ``hual_tpu_torch/csrc/``, built
with nvcc at first use (``build.py``), one wrapper module per kernel."""
