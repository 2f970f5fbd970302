"""hual_tpu_torch: the PyTorch / CUDA port of ``hual_tpu`` for NVIDIA Hopper.

The JAX package ``hual_tpu`` stays beside it as the reference.  This package
imports neither it nor JAX.  Ported so far: the serving path
(``serve.Predictor``) with the SeqPAN deterministic forward and the span
decode kernel (K1); the data pipeline, training and the eval and
AL-inference sweeps (``runtime.trainer.Trainer``, its table on the card or
streamed from the host) with the fused-forward kernel (K2); the AL round
engine (``active``), the in-process round loop (``orchestrate``), the
command line (``cli``), the native feature loader (``native``) and data
parallelism on ``torch.distributed`` (``parallel``).
"""
