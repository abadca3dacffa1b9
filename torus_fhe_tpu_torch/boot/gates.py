"""The bootstrapped boolean gate set, batch-first.

Port of torus_fhe_tpu/boot/gates.py: each two-input gate is one affine
combination of the input batches plus one gate bootstrap; NOT is free; MUX
costs two rotate-extracts and one keyswitch. Every bootstrapped gate runs
inside an ``fhe.gate`` span (utils/profiling.span).
"""

from __future__ import annotations

import torch

from ..core.torus import encode_message
from ..lwe import LweSample, lwe_noiseless_trivial
from ..utils.profiling import spanned
from .api import CloudKey
from .bootstrap import bootstrap, bootstrap_wo_keyswitch
from .keyswitch import keyswitch


# +-1/8 and +-1/4 as Python ints: the bootstrap takes its test-vector mu static
EIGHTH = {s: int(encode_message(s, 8)) for s in (-1, 1)}
QUARTER = {s: int(encode_message(s, 4)) for s in (-1, 1)}
gate_span = spanned("fhe.gate")  # also mk/gates3gen's


def _trivial_like(ck: CloudKey, x: LweSample, mu: int) -> LweSample:
    return lwe_noiseless_trivial(mu, ck.params.lwe, x.b.shape, device=x.b.device)


def _boot(ck: CloudKey, t: LweSample) -> LweSample:
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, EIGHTH[1], t, ck.params)


@gate_span
def gate_nand(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, EIGHTH[1]) - x - y)


@gate_span
def gate_or(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, EIGHTH[1]) + x + y)


@gate_span
def gate_and(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, EIGHTH[-1]) + x + y)


@gate_span
def gate_xor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, QUARTER[1]) + (x + y).scale(2))


@gate_span
def gate_xnor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, QUARTER[-1]) - (x + y).scale(2))


@gate_span
def gate_nor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, EIGHTH[-1]) - x - y)


@gate_span
def gate_andny(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, EIGHTH[-1]) - x + y)


@gate_span
def gate_andyn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, EIGHTH[-1]) + x - y)


@gate_span
def gate_orny(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, EIGHTH[1]) - x + y)


@gate_span
def gate_oryn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    return _boot(ck, _trivial_like(ck, x, EIGHTH[1]) + x - y)


def gate_not(ck: CloudKey, x: LweSample) -> LweSample:
    return -x


def gate_constant(ck: CloudKey, values: torch.Tensor, device=None) -> LweSample:
    """Noiseless encryptions of the booleans ``values``, on ``device`` (None:
    where the cloud key lives)."""
    if device is None:
        device = ck.keyswitch_key.mat.device
    values = torch.as_tensor(values, dtype=torch.bool, device=device)
    mu = torch.where(values, EIGHTH[1], EIGHTH[-1]).to(torch.int32)
    return lwe_noiseless_trivial(mu, ck.params.lwe, values.shape, device=values.device)


@gate_span
def gate_mux(ck: CloudKey, x: LweSample, y: LweSample, z: LweSample) -> LweSample:
    """MUX(x, y, z) = x ? y : z — two rotate-extracts and one keyswitch."""
    t1 = _trivial_like(ck, x, EIGHTH[-1]) + x + y
    u1 = bootstrap_wo_keyswitch(ck.bootstrap_key, EIGHTH[1], t1, ck.params)
    t2 = _trivial_like(ck, x, EIGHTH[-1]) - x + z
    u2 = bootstrap_wo_keyswitch(ck.bootstrap_key, EIGHTH[1], t2, ck.params)
    t3 = lwe_noiseless_trivial(EIGHTH[1], ck.params.extracted_lwe, u1.b.shape,
                               device=u1.b.device) + u1 + u2
    return keyswitch(ck.keyswitch_key, ck.params.ks, t3)


BINARY_GATES = {
    "nand": gate_nand, "or": gate_or, "and": gate_and, "xor": gate_xor,
    "xnor": gate_xnor, "nor": gate_nor, "andny": gate_andny,
    "andyn": gate_andyn, "orny": gate_orny, "oryn": gate_oryn,
}
