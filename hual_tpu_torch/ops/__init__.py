"""Tensor ops of the port: masking, the plain span decode, and (under
``kernels/``) the hand-written CUDA kernels with their wrappers."""
