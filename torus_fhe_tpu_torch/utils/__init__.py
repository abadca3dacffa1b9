"""Utilities around the schemes: the noise and wrong-decryption harness
(``noise``), tracing and the per-category device breakdown on
torch.profiler (``profiling``), and key and ciphertext files
(``serialize``)."""

from . import noise, profiling, serialize  # noqa: F401
