"""3rd-gen multikey bootstrapped gates, batch-first.

Port of the gate half of torus_fhe_tpu/mk/gates3gen.py: each gate is one
affine combination of multikey ciphertext batches plus one multikey
bootstrap; NOT is free; MUX is two rotate-extracts and one keyswitch. The
``_wb`` variants are the affine parts alone, without the bootstrap.
"""

from __future__ import annotations

import torch

from ..boot.gates import EIGHTH, QUARTER
from ..lwe import LweSample
from .boot3gen import mk_bootstrap, mk_bootstrap_wo_keyswitch, mk_keyswitch
from .keys3gen import MKCloudKey
from .samples import MKLweSample, mk_lwe_noiseless_trivial

MU = 1 << 61  # encode_message(1, 8) on the 64-bit ring torus: the test vector


def _trivial_like(ck: MKCloudKey, x: MKLweSample, mu: int) -> MKLweSample:
    return mk_lwe_noiseless_trivial(mu, ck.params.lwe, ck.parties, x.b.shape,
                                    device=x.b.device)


def mk_gate_nand_wb(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return _trivial_like(ck, x, EIGHTH[1]) - x - y


def mk_gate_or_wb(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return _trivial_like(ck, x, EIGHTH[1]) + x + y


def mk_gate_and_wb(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return _trivial_like(ck, x, EIGHTH[-1]) + x + y


def mk_gate_xor_wb(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return _trivial_like(ck, x, QUARTER[1]) + (x + y).scale(2)


def mk_gate_nand(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return mk_bootstrap(ck, MU, mk_gate_nand_wb(ck, x, y))


def mk_gate_or(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return mk_bootstrap(ck, MU, mk_gate_or_wb(ck, x, y))


def mk_gate_and(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return mk_bootstrap(ck, MU, mk_gate_and_wb(ck, x, y))


def mk_gate_xor(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return mk_bootstrap(ck, MU, mk_gate_xor_wb(ck, x, y))


def mk_gate_3and(ck: MKCloudKey, x: MKLweSample, y: MKLweSample,
                 z: MKLweSample) -> MKLweSample:
    """3-input AND in one bootstrap."""
    return mk_bootstrap(ck, MU, _trivial_like(ck, x, QUARTER[-1]) + x + y + z)


def mk_gate_not(ck: MKCloudKey, x: MKLweSample) -> MKLweSample:
    return -x


def mk_gate_mux(ck: MKCloudKey, x: MKLweSample, y: MKLweSample,
                z: MKLweSample) -> MKLweSample:
    """MUX(x, y, z) = x ? y : z: two rotate-extracts, one keyswitch."""
    u1 = mk_bootstrap_wo_keyswitch(ck, MU, _trivial_like(ck, x, EIGHTH[-1]) + x + y)
    u2 = mk_bootstrap_wo_keyswitch(ck, MU, _trivial_like(ck, x, EIGHTH[-1]) - x + z)
    return mk_keyswitch(ck, LweSample(u1.a + u2.a, u1.b + u2.b + EIGHTH[1]))


def mk_gate_constant(ck: MKCloudKey, values, device=None) -> MKLweSample:
    """Noiseless trivial multikey encryptions of the booleans ``values``, on
    ``device`` (None: where the cloud key lives)."""
    if device is None:
        device = ck.ks_mat.device
    values = torch.as_tensor(values, dtype=torch.bool, device=device)
    mu = torch.where(values, EIGHTH[1], EIGHTH[-1]).to(torch.int32)
    return mk_lwe_noiseless_trivial(mu, ck.params.lwe, ck.parties, values.shape,
                                    device=values.device)


BINARY_GATES = {"nand": mk_gate_nand, "or": mk_gate_or, "and": mk_gate_and,
                "xor": mk_gate_xor}
BINARY_GATES_WB = {"nand": mk_gate_nand_wb, "or": mk_gate_or_wb,
                   "and": mk_gate_and_wb, "xor": mk_gate_xor_wb}
