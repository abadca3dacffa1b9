"""PyTorch + CUDA port of torus_fhe_tpu.

Module paths mirror the JAX package: ``core/`` (params, torus, rng, device),
``ops/`` (poly, fblock, hostmath, and the Hopper blind-rotate kernels in
``ops/cuda_rotate.py`` + ``csrc/``), ``lwe``/``rlwe``/``tgsw``, ``boot/``
(keyswitch, bootstrap, gates, api), ``mk/`` (3rd-gen multikey keys, gates and
integer circuits), ``threshold/`` (shares, decryption, the LWE -> ring-LWE
embedding, public-key encryption, Shamir and additive key splitting),
``boot/public_sample`` and ``boot/pack`` (fresh ciphertexts from the cloud
key, LWE -> RLWE packing), ``circuits/`` (single-key word circuits), ``apps/`` (KNN, CNN,
volume matching, multikey KNN), ``parallel/`` (meshes of devices),
``utils/serialize`` (the JAX package's key files), and ``bridge`` (key
material from the JAX package, as numpy arrays); ``cli`` is the file-based
CLI (``python -m torus_fhe_tpu_torch``).

Everything is plain functions on tensors, batch-first, with the JAX package's
layouts: an LWE sample is ``a (..., n)``, ``b (...,)``; an RLWE sample is
``(..., k+1, N)`` with the body last; torus values are int32 wrapping mod 2^32.
CPU tensors run the plain PyTorch versions; CUDA tensors run the kernels.

This package imports torch and numpy, never jax.
"""
