"""Threshold decryption: Benaloh–Leichter key shares and the partial/final
decryption of ring-LWE samples.

Port of the ``shares`` and ``decrypt`` names of
torus_fhe_tpu/threshold/__init__.py.
"""

from . import decrypt, shares
from .decrypt import (decode_bits, encode_bits, final_decrypt, partial_decrypt,
                      threshold_decrypt)
from .shares import (ShareSet, build_distribution_matrix, find_group_id,
                     find_parties, ncr, share_secret, share_secret_streaming)
