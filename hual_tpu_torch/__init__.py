"""hual_tpu_torch: the PyTorch / CUDA port of ``hual_tpu`` for NVIDIA Hopper.

The JAX package ``hual_tpu`` stays beside it as the reference.  This package
imports neither it nor JAX.  Ported so far: the serving path
(``serve.Predictor``) with the SeqPAN deterministic forward and the span
decode kernel.
"""
