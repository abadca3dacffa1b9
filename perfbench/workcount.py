"""The work of a gate bootstrap, counted from the parameter set and the
batch alone: the yardstick of the roofline shares.

The count does not look at the key form or the kernel that the program
happens to use; a later kernel is held against the same work.

- Blind rotate: per gate, ``steps`` CMux steps (n; 3gen: parties * n), each
  an external product of R = l (k+1) digit polynomials against the TGSW
  row polynomials, taken as int8 multiply-accumulates of a digit (|d| <=
  Bg/2 <= 128) by each of the 4 byte limbs of a 32-bit key word: R N
  digits x (k+1) N outputs x 4 limbs. Two operations each.
  Bytes: the key read once in the smallest form the port holds, one
  32-bit word per coefficient of every TGSW row polynomial (steps x R x
  (k+1) x N x 4; the 3gen key rounded to its high word), plus the mod-switched
  mask (steps words a gate) and the accumulator in and out ((k+1) N words a
  gate each way).
- Keyswitch: per gate, one 32-bit add of a table row (parties (n + 1)
  words) for each of the n_in t digits; bytes: the table read once
  (n_in t (2^lb - 1) rows), the extracted sample in (n_in + 1 words) and
  the switched one out (parties n + 1 words).

It counts the key forms that hold a 32-bit word a key coefficient: the
single-key set, and the 3gen set at digits that allow the hi-word key (l lb
<= 31, lb <= 8). Of any other configuration (the exact 64-bit 3gen chain,
another scheme) it counts nothing and returns None.

The bound of a launch is the larger of operations over the int8 peak and
bytes over the memory rate of an H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit).
"""

from __future__ import annotations

from typing import NamedTuple

INT8_OPS_PER_S = 1979e12
BYTES_PER_S = 3.35e12
WORD = 4  # bytes of a 32-bit torus word
LIMBS = 4  # byte limbs of a 32-bit key word


class Work(NamedTuple):
    ops: float
    nbytes: float

    def bound_s(self) -> float:
        """The least time an H100 SXM could take."""
        return max(self.ops / INT8_OPS_PER_S, self.nbytes / BYTES_PER_S)

    def bound_by(self) -> str:
        return "operations" if self.ops / INT8_OPS_PER_S >= self.nbytes / BYTES_PER_S else "bytes"


def _shape(cfg: dict):
    """(steps, l, C, N, parties) of a configuration the count reads, else
    None."""
    p, parties = cfg["params"], cfg["parties"]
    if cfg["scheme"] == "single":
        l = p["bs_decomp_length"]
    elif (cfg["scheme"] == "3gen" and p["gsw_decomp_length"] * p["gsw_log2_base"] <= 31
          and p["gsw_log2_base"] <= 8):
        l = p["gsw_decomp_length"]
    else:
        return None
    return parties * p["lwe_size"], l, p["rlwe_mask_size"] + 1, p["rlwe_polynomial_degree"], parties


def rotate(cfg: dict, batch: int):
    """One blind rotate of ``batch`` gates, or None."""
    shape = _shape(cfg)
    if shape is None:
        return None
    steps, l, C, N, _ = shape
    R = l * C
    macs = steps * batch * (R * N) * (C * N * LIMBS)
    key = steps * R * C * N * WORD
    return Work(2.0 * macs, float(key + batch * steps * WORD + 2 * batch * C * N * WORD))


def keyswitch(cfg: dict, batch: int):
    """One keyswitch of ``batch`` gates, or None."""
    shape = _shape(cfg)
    if shape is None:
        return None
    p = cfg["params"]
    _, _, C, N, parties = shape
    n_in = (C - 1) * N
    t, base = p["ks_decomp_length"], 1 << p["ks_log2_base"]
    row = parties * (p["lwe_size"] + 1)
    adds = batch * n_in * t * row
    table = n_in * t * (base - 1) * row * WORD
    out = parties * p["lwe_size"] + 1
    return Work(float(adds), float(table + batch * (n_in + 1 + out) * WORD))
