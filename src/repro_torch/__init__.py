"""PyTorch + CUDA port of the edge/cloud collaborative serving system.

Laid out module for module like the JAX package ``repro``, which stays the
reference this package is held against.  It imports neither ``jax`` nor
``repro``.
"""
