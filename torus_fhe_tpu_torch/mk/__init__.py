"""Multikey TFHE: the 3rd-gen (AKÖ) samples, keys, bootstrap and gates at
the top level, and the 1st-gen (CCS) and 2nd-gen (KMS) schemes as the
modules ``ccs`` and ``kms``.

Port of torus_fhe_tpu/mk/__init__.py.
"""

from . import boot3gen, ccs, gates3gen, keys3gen, kms, samples
from .boot3gen import mk_bootstrap, mk_bootstrap_wo_keyswitch, mk_keyswitch
from .keys3gen import (CRP, MKCloudKey, MKSecretKey, common_public_key,
                       default_forms, gen_crp, mk_cloud_keygen, mk_party_keygen,
                       public_keygen, tgsw_encrypt_3gen)
from .samples import (MKLweSample, mk_decrypt, mk_encrypt, mk_int_decrypt,
                      mk_int_encrypt, mk_lwe_noiseless_trivial, mk_lwe_phase)
