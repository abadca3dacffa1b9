"""PyTorch + CUDA port of torus_fhe_tpu (single-key gate bootstrap slice).

Module paths mirror the JAX package: ``core/`` (params, torus, rng),
``ops/`` (poly, fblock, hostmath, and the Hopper blind-rotate kernel in
``ops/cuda_rotate.py`` + ``csrc/blind_rotate.cu``), ``lwe``/``rlwe``/``tgsw``,
``boot/`` (keyswitch, bootstrap, gates, api), and ``bridge`` (key material
from the JAX package, as numpy arrays).

Everything is plain functions on tensors, batch-first, with the JAX package's
layouts: an LWE sample is ``a (..., n)``, ``b (...,)``; an RLWE sample is
``(..., k+1, N)`` with the body last; torus values are int32 wrapping mod 2^32.
CPU tensors run the plain PyTorch versions; CUDA tensors run the kernel.

This package imports torch and numpy, never jax.
"""
