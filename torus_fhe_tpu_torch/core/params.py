"""Frozen parameter dataclasses for the single-key scheme.

Port of torus_fhe_tpu/core/params.py (the single-key part). Parameters are
static Python values; equal field by field to the JAX package's.
"""

from __future__ import annotations

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


# Small parameter sets for fast unit tests (not secure; same structure).
def test_parameters(n: int = 16, N: int = 64, bits: int = 32) -> SchemeParams:
    return SchemeParams(
        n, 2**-15,
        N, 1, bits,
        3, 7, 2**-25,
        8, 2, 2**-15,
    )
