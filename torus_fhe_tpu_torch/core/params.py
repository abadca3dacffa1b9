"""Frozen parameter dataclasses for the single-key scheme and the three
multikey schemes (3rd-gen AKÖ, 1st-gen CCS, 2nd-gen KMS).

Port of torus_fhe_tpu/core/params.py. Parameters are static Python values;
equal field by field, and in the same field order, to the JAX package's (the
key files name the class and its fields, utils/serialize.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LweParams:
    size: int  # n, the LWE mask length


@dataclass(frozen=True)
class RLweParams:
    polynomial_degree: int  # N, a power of two
    mask_size: int  # k, number of mask polynomials
    bits: int = 32  # torus width: 32 or 64

    @property
    def torus_dtype(self) -> torch.dtype:
        return torch.int32 if self.bits == 32 else torch.int64


@dataclass(frozen=True)
class TGswParams:
    """Gadget decomposition parameters."""

    decomp_length: int  # l
    log2_base: int  # log2(B)
    bits: int = 32  # torus width of the decomposed samples

    @property
    def gadget_values(self) -> tuple:
        """1/B^i on the torus, i = 1..l, as python ints (mod 2^bits, signed)."""
        vals = []
        for i in range(1, self.decomp_length + 1):
            shift = self.bits - i * self.log2_base
            v = (1 << shift) if shift >= 0 else 0
            vals.append(_signed(v, self.bits))
        return tuple(vals)

    @property
    def offset(self) -> int:
        """Decomposition offset: B/2 * sum(gadget values) + q/2, wrapped signed.

        The B/2 terms centre each digit in [-B/2, B/2); the q/2 =
        2^(bits - l*log2B - 1) term turns the truncation of the sub-gadget bits
        into round-to-nearest.
        """
        total = sum((1 << (self.bits - i * self.log2_base)) if self.bits - i * self.log2_base >= 0 else 0
                    for i in range(1, self.decomp_length + 1))
        off = (total * (1 << (self.log2_base - 1))) % (1 << self.bits)
        sub = self.bits - self.decomp_length * self.log2_base
        if sub > 0:
            off = (off + (1 << (sub - 1))) % (1 << self.bits)
        return _signed(off, self.bits)


@dataclass(frozen=True)
class KeyswitchParams:
    decomp_length: int  # t (digits per coefficient)
    log2_base: int  # log2(base)


def _signed(v: int, bits: int) -> int:
    v %= 1 << bits
    return v - (1 << bits) if v >= 1 << (bits - 1) else v


@dataclass(frozen=True)
class SchemeParams:
    """Single-key TFHE scheme parameters."""

    lwe_size: int
    lwe_noise_stddev: float

    rlwe_polynomial_degree: int
    rlwe_mask_size: int
    rlwe_bits: int

    bs_decomp_length: int
    bs_log2_base: int
    bs_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int = 1
    # dropped low BODY bytes of the F-block bootstrapping key; the body is
    # rounded to 2^(8*bk_drop_limbs) at keygen, so the dropped bytes are zero
    bk_drop_limbs: int = 0
    # withdrawn quantized-mask key (insecure); kept only so that parameter
    # sets compare equal to the JAX package's. Keygen refuses any value but 0.
    bk_mask_quantum_bits: int = 0

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_size)

    @property
    def rlwe(self) -> RLweParams:
        return RLweParams(self.rlwe_polynomial_degree, self.rlwe_mask_size, self.rlwe_bits)

    @property
    def tgsw(self) -> TGswParams:
        return TGswParams(self.bs_decomp_length, self.bs_log2_base, self.rlwe_bits)

    @property
    def ks(self) -> KeyswitchParams:
        return KeyswitchParams(self.ks_decomp_length, self.ks_log2_base)

    @property
    def extracted_lwe(self) -> LweParams:
        """LWE params of samples extracted from RLWE (size = k * N)."""
        return LweParams(self.rlwe_polynomial_degree * self.rlwe_mask_size)


def tfhe_parameters_80(rlwe_mask_size: int = 1) -> SchemeParams:
    """~80-bit security CGGI parameters (n=500, N=1024, l=2, Bg=2^10): digits
    wider than a byte, so the blind rotate takes the torch-op scan."""
    return SchemeParams(
        500, 1 / 2**15 * math.sqrt(2 / math.pi),
        1024, rlwe_mask_size, 32,
        2, 10, 9e-9 * math.sqrt(2 / math.pi),
        8, 2, 1 / 2**15 * math.sqrt(2 / math.pi),
    )


def tfhe_parameters_128(rlwe_mask_size: int = 1) -> SchemeParams:
    """~128-bit security CGGI2019 parameters (n=630, N=1024, l=3, Bg=2^7)."""
    return SchemeParams(
        630, 1 / 2**15,
        1024, rlwe_mask_size, 32,
        3, 7, 1 / 2**25,
        8, 2, 1 / 2**15,
    )


def tfhe_parameters_128_tpu() -> SchemeParams:
    """tfhe_parameters_128 with the bootstrapping key's lowest body byte
    rounded away at keygen (F-block key of 7 limb columns)."""
    return SchemeParams(
        630, 1 / 2**15,
        1024, 1, 32,
        3, 7, 1 / 2**25,
        8, 2, 1 / 2**15,
        bk_drop_limbs=1,
    )


def tfhe_parameters_128_tpu_fast() -> SchemeParams:
    """128-bit module-LWE set: k=2, N=512 (lattice dimension k*N = 1024),
    l=2, Bg=2^8, body rounded to 2^8 (F-block key of 11 limb columns)."""
    return SchemeParams(
        630, 1 / 2**15,
        512, 2, 32,
        2, 8, 1 / 2**25,
        8, 2, 1 / 2**15,
        bk_drop_limbs=1,
    )


def thfhe_parameters_1024() -> SchemeParams:
    """The threshold set: n = N = 1024, so the LWE key maps 1:1 to a
    degree-1024 ring key."""
    return SchemeParams(
        1024, 2**-15,
        1024, 1, 32,
        3, 7, 2**-25,
        8, 2, 2**-15,
    )


# Small parameter sets for fast unit tests (not secure; same structure).
def test_parameters(n: int = 16, N: int = 64, bits: int = 32) -> SchemeParams:
    return SchemeParams(
        n, 2**-15,
        N, 1, bits,
        3, 7, 2**-25,
        8, 2, 2**-15,
    )


@dataclass(frozen=True)
class SchemeParams3Gen:
    """3rd-gen (AKÖ) multikey TFHE parameters: a 64-bit ring torus, a
    32-bit LWE torus, and the largest number of parties the set serves."""

    lwe_size: int
    lwe_noise_stddev: float

    rlwe_polynomial_degree: int
    rlwe_mask_size: int
    rlwe_bits: int

    gsw_decomp_length: int
    gsw_log2_base: int
    gsw_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_size)

    @property
    def rlwe(self) -> RLweParams:
        return RLweParams(self.rlwe_polynomial_degree, self.rlwe_mask_size, self.rlwe_bits)

    @property
    def tgsw(self) -> TGswParams:
        return TGswParams(self.gsw_decomp_length, self.gsw_log2_base, self.rlwe_bits)

    @property
    def ks(self) -> KeyswitchParams:
        return KeyswitchParams(self.ks_decomp_length, self.ks_log2_base)


def mktfhe_parameters_2party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(520, 2**-13.52, 1024, 1, 64, 2, 7, 2**-30.70, 3, 3, 2**-13.52, 2)


def mktfhe_parameters_3party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(510, 2**-13.26, 1024, 1, 64, 2, 7, 2**-30.70, 5, 2, 2**-13.26, 3)


def mktfhe_parameters_4party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(510, 2**-13.26, 1024, 1, 64, 3, 6, 2**-30.70, 5, 2, 2**-13.26, 4)


def mktfhe_parameters_8party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(540, 2**-14.04, 1024, 1, 64, 4, 4, 2**-30.70, 5, 2, 2**-14.04, 8)


# The sets below have Bg >= 2^18: their key keeps the exact 64-bit lines
# (mk/keys3gen.mk_fb64_geometry) and their blind rotate is the torch-op scan.
def mktfhe_parameters_16party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(590, 2**-15.34, 2048, 1, 64, 1, 26, 2**-62.0, 4, 3, 2**-15.34, 16)


def mktfhe_parameters_32party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(620, 2**-16.12, 2048, 1, 64, 1, 26, 2**-62.0, 4, 3, 2**-16.12, 32)


def mktfhe_parameters_32party_3gen_for_fft() -> SchemeParams3Gen:
    return SchemeParams3Gen(680, 2**-17.68, 2048, 1, 64, 1, 25, 2**-62.0, 5, 3, 2**-17.68, 32)


def mktfhe_parameters_64party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(650, 2**-16.90, 2048, 1, 64, 1, 25, 2**-62.0, 4, 3, 2**-16.90, 64)


def mktfhe_parameters_64party_3gen_for_fft() -> SchemeParams3Gen:
    return SchemeParams3Gen(720, 2**-18.72, 4096, 1, 64, 1, 27, 2**-62.0, 5, 3, 2**-18.72, 64)


def mktfhe_parameters_128party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(670, 2**-17.42, 2048, 1, 64, 1, 24, 2**-62.0, 5, 3, 2**-17.42, 128)


def mktfhe_parameters_256party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(740, 2**-19.24, 2048, 1, 64, 2, 18, 2**-62.0, 8, 2, 2**-19.24, 256)


def mktfhe_parameters_512party_3gen() -> SchemeParams3Gen:
    return SchemeParams3Gen(730, 2**-18.98, 4096, 1, 64, 1, 27, 2**-62.0, 5, 3, 2**-18.98, 512)


def test_parameters_3gen(parties: int = 2, n: int = 16, N: int = 64) -> SchemeParams3Gen:
    """Tiny insecure 3gen parameter set for unit tests."""
    return SchemeParams3Gen(n, 2**-13.52, N, 1, 64, 2, 7, 2**-30.70, 3, 3, 2**-13.52, parties)


@dataclass(frozen=True)
class SchemeParamsCCS:
    """1st-gen (CCS) multikey parameters: a 32-bit torus throughout, one
    gadget (bs_*) for the uni-encryptions, the public keys and the shared key."""

    lwe_size: int
    lwe_noise_stddev: float

    rlwe_polynomial_degree: int
    rlwe_mask_size: int
    rlwe_bits: int

    bs_decomp_length: int
    bs_log2_base: int
    bs_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_size)

    @property
    def rlwe(self) -> RLweParams:
        return RLweParams(self.rlwe_polynomial_degree, self.rlwe_mask_size, self.rlwe_bits)

    @property
    def tgsw(self) -> TGswParams:
        return TGswParams(self.bs_decomp_length, self.bs_log2_base, self.rlwe_bits)

    @property
    def ks(self) -> KeyswitchParams:
        return KeyswitchParams(self.ks_decomp_length, self.ks_log2_base)


def mktfhe_parameters_2party_ccs() -> SchemeParamsCCS:
    return SchemeParamsCCS(560, 3.05e-5, 1024, 1, 32, 3, 9, 3.72e-9, 8, 2, 3.05e-5, 2)


def mktfhe_parameters_4party_ccs() -> SchemeParamsCCS:
    return SchemeParamsCCS(560, 3.05e-5, 1024, 1, 32, 4, 8, 3.72e-9, 8, 2, 3.05e-5, 4)


def mktfhe_parameters_8party_ccs() -> SchemeParamsCCS:
    return SchemeParamsCCS(560, 3.05e-5, 1024, 1, 32, 5, 6, 3.72e-9, 8, 2, 3.05e-5, 8)


def mktfhe_parameters_16party_ccs() -> SchemeParamsCCS:
    return SchemeParamsCCS(560, 3.05e-5, 1024, 1, 32, 12, 2, 3.72e-9, 8, 2, 3.05e-5, 16)


def test_parameters_ccs(parties: int = 2, n: int = 16, N: int = 64) -> SchemeParamsCCS:
    """Tiny insecure CCS parameter set for unit tests (the 2-party gadget,
    Bg = 2^9: digits wider than a byte)."""
    return SchemeParamsCCS(n, 3.05e-5, N, 1, 32, 3, 9, 3.72e-9, 8, 2, 3.05e-5, parties)


@dataclass(frozen=True)
class SchemeParamsKMS:
    """2nd-gen (KMS) multikey parameters: a 64-bit ring torus, three gadgets
    (gsw_* for the per-party TGSW of the LWE key bits, lev_* for the TLev
    accumulator, uni_* for the relinearisation key) and a 32-bit LWE torus."""

    lwe_size: int
    lwe_noise_stddev: float

    rlwe_polynomial_degree: int
    rlwe_mask_size: int
    rlwe_bits: int

    gsw_decomp_length: int
    gsw_log2_base: int
    gsw_noise_stddev: float

    lev_decomp_length: int
    lev_log2_base: int

    uni_decomp_length: int
    uni_log2_base: int
    uni_noise_stddev: float

    ks_decomp_length: int
    ks_log2_base: int
    ks_noise_stddev: float

    max_parties: int

    @property
    def lwe(self) -> LweParams:
        return LweParams(self.lwe_size)

    @property
    def rlwe(self) -> RLweParams:
        return RLweParams(self.rlwe_polynomial_degree, self.rlwe_mask_size, self.rlwe_bits)

    @property
    def tgsw(self) -> TGswParams:
        return TGswParams(self.gsw_decomp_length, self.gsw_log2_base, self.rlwe_bits)

    @property
    def tlev(self) -> TGswParams:
        return TGswParams(self.lev_decomp_length, self.lev_log2_base, self.rlwe_bits)

    @property
    def uni(self) -> TGswParams:
        return TGswParams(self.uni_decomp_length, self.uni_log2_base, self.rlwe_bits)

    @property
    def ks(self) -> KeyswitchParams:
        return KeyswitchParams(self.ks_decomp_length, self.ks_log2_base)


def mktfhe_parameters_2party_kms(fast: bool = False) -> SchemeParamsKMS:
    uni = (3, 10) if fast else (2, 13)
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 3, 13, 4.63e-18,
                           2, 7, uni[0], uni[1], 4.63e-18, 8, 2, 3.05e-5, 2)


def mktfhe_parameters_4party_kms(fast: bool = False) -> SchemeParamsKMS:
    uni = (7, 6) if fast else (5, 8)
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 5, 8, 4.63e-18,
                           2, 8, uni[0], uni[1], 4.63e-18, 8, 2, 3.05e-5, 4)


def mktfhe_parameters_8party_kms(fast: bool = False) -> SchemeParamsKMS:
    uni = (7, 4) if fast else (8, 4)
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 4, 11, 4.63e-18,
                           3, 6, uni[0], uni[1], 4.63e-18, 8, 2, 3.05e-5, 8)


def mktfhe_parameters_16party_kms(fast: bool = False) -> SchemeParamsKMS:
    uni = (7, 4) if fast else (9, 4)
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 5, 9, 4.63e-18,
                           3, 6, uni[0], uni[1], 4.63e-18, 8, 2, 3.05e-5, 16)


def mktfhe_parameters_32party_kms(fast: bool = False) -> SchemeParamsKMS:
    """The fast and the plain set are the same at 32 parties."""
    return SchemeParamsKMS(560, 3.05e-5, 2048, 1, 64, 6, 8, 4.63e-18,
                           3, 7, 16, 2, 4.63e-18, 8, 2, 3.05e-5, 32)


def test_parameters_kms(parties: int = 2, n: int = 16, N: int = 64) -> SchemeParamsKMS:
    """Tiny insecure KMS parameter set for unit tests (64-bit torus, the
    2-party gadgets, a small ring)."""
    return SchemeParamsKMS(n, 3.05e-5, N, 1, 64, 3, 13, 4.63e-18,
                           2, 7, 2, 13, 4.63e-18, 8, 2, 3.05e-5, parties)


# The JAX package's registry names for the sets this package defines.
PARAMETER_REGISTRY = {
    "tfhe_80": tfhe_parameters_80,
    "tfhe_128": tfhe_parameters_128,
    "tfhe_128_tpu": tfhe_parameters_128_tpu,
    "tfhe_128_tpu_fast": tfhe_parameters_128_tpu_fast,
    "tfhe_test_small": test_parameters,  # INSECURE; tests only
    "thfhe_1024": thfhe_parameters_1024,
    "mk_2party_3gen": mktfhe_parameters_2party_3gen,
    "mk_3party_3gen": mktfhe_parameters_3party_3gen,
    "mk_4party_3gen": mktfhe_parameters_4party_3gen,
    "mk_8party_3gen": mktfhe_parameters_8party_3gen,
    "mk_16party_3gen": mktfhe_parameters_16party_3gen,
    "mk_32party_3gen": mktfhe_parameters_32party_3gen,
    "mk_32party_3gen_for_fft": mktfhe_parameters_32party_3gen_for_fft,
    "mk_64party_3gen": mktfhe_parameters_64party_3gen,
    "mk_64party_3gen_for_fft": mktfhe_parameters_64party_3gen_for_fft,
    "mk_128party_3gen": mktfhe_parameters_128party_3gen,
    "mk_256party_3gen": mktfhe_parameters_256party_3gen,
    "mk_512party_3gen": mktfhe_parameters_512party_3gen,
    "mk_2party_ccs": mktfhe_parameters_2party_ccs,
    "mk_4party_ccs": mktfhe_parameters_4party_ccs,
    "mk_8party_ccs": mktfhe_parameters_8party_ccs,
    "mk_16party_ccs": mktfhe_parameters_16party_ccs,
    "mk_2party_kms": mktfhe_parameters_2party_kms,
    "mk_4party_kms": mktfhe_parameters_4party_kms,
    "mk_8party_kms": mktfhe_parameters_8party_kms,
    "mk_16party_kms": mktfhe_parameters_16party_kms,
    "mk_32party_kms": mktfhe_parameters_32party_kms,
}
