"""PyTorch + CUDA port of ``fsae_mpc_tpu`` (batch-first, for NVIDIA Hopper).

The JAX package ``fsae_mpc_tpu`` is the reference; this package mirrors its
layout and module names.  It imports ``torch`` and never ``jax``.
"""
