"""Threshold decryption: Benaloh–Leichter key shares, the partial/final
decryption of ring-LWE samples, the LWE -> ring-LWE embedding, public-key
encryption, Shamir key sharding and additive key splitting with smudging.

Port of torus_fhe_tpu/threshold/__init__.py, with the same names.
"""

from . import additive, convert, decrypt, pk, shamir, shares
from .additive import (AdditiveShares, combine, lwe_partial_decrypt,
                       max_tolerable_bound, rlwe_partial_decrypt,
                       split_additive, split_lwe_key, split_rlwe_key)
from .convert import tlwe_from_lwe, tlwe_key_from_lwe_key
from .decrypt import (decode_bits, encode_bits, final_decrypt, partial_decrypt,
                      threshold_decrypt)
from .pk import PublicKey, public_encrypt, public_keygen
from .shares import (ShareSet, build_distribution_matrix, find_group_id,
                     find_parties, ncr, share_secret, share_secret_streaming)
