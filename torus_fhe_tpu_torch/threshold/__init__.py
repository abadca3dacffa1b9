"""Threshold decryption: Benaloh–Leichter key shares, the partial/final
decryption of ring-LWE samples, and the LWE -> ring-LWE embedding.

Port of the ``shares``, ``decrypt`` and ``convert`` names of
torus_fhe_tpu/threshold/__init__.py.
"""

from . import convert, decrypt, shares
from .convert import tlwe_from_lwe, tlwe_key_from_lwe_key
from .decrypt import (decode_bits, encode_bits, final_decrypt, partial_decrypt,
                      threshold_decrypt)
from .shares import (ShareSet, build_distribution_matrix, find_group_id,
                     find_parties, ncr, share_secret, share_secret_streaming)
