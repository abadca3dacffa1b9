"""The frozen work count against hand counts, and its independence from
the key form the program holds."""

import json
import os

import numpy as np
import torch

from perfbench import keys as K
from perfbench import workcount
from perfbench.tests.conftest import ROOT, small_config


def config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


def test_rotate_tfhe128_by_hand():
    w = workcount.rotate(config("tfhe128"), 1024)
    # 630 steps x 1024 gates x (3*2 digit polys x 1024) x (2 polys x 1024 x 4 limbs)
    assert w.ops == 2 * 630 * 1024 * 6144 * 8192 == 64_939_905_515_520
    # key 630 x 6 x 2 x 1024 words, bara 1024 x 630, accumulator in and out
    assert w.nbytes == 4 * (630 * 6 * 2 * 1024 + 1024 * 630 + 2 * 1024 * 2 * 1024)
    assert w.bound_by() == "operations"
    assert abs(w.bound_s() * 1e3 - 32.8145) < 1e-3


def test_rotate_mk2p3gen_by_hand():
    w = workcount.rotate(config("mk2p3gen"), 1024)
    # 2 x 520 steps, l = 2: 4 digit polys
    assert w.ops == 2 * 1040 * 1024 * 4096 * 8192
    assert w.nbytes == 4 * (1040 * 4 * 2 * 1024 + 1024 * 1040 + 2 * 1024 * 2 * 1024)
    assert abs(w.bound_s() * 1e3 - 36.1134) < 1e-3


def test_rotate_b1_is_bound_by_operations_at_both_sets():
    for name, steps in (("tfhe128", 630), ("mk2p3gen", 1040)):
        w = workcount.rotate(config(name), 1)
        assert w.bound_by() == "operations"
        assert w.ops == 2 * steps * (w.ops // (2 * steps))


def test_keyswitch_by_hand():
    w = workcount.keyswitch(config("tfhe128"), 1024)
    assert w.ops == 1024 * 1024 * 8 * 631
    assert w.nbytes == 4 * (1024 * 8 * 3 * 631 + 1024 * (1025 + 631))
    w = workcount.keyswitch(config("mk2p3gen"), 1024)
    assert w.ops == 1024 * 1024 * 3 * 2 * 521
    assert w.nbytes == 4 * (1024 * 3 * 7 * 1042 + 1024 * (1025 + 1041))


def test_count_does_not_follow_the_key_form():
    """The program's expanded (fblock) and compact (fbstream) 3gen keys of
    one set: one count, which reads no more key bytes than either holds."""
    from torus_fhe_tpu_torch.mk import keys3gen
    from perfbench import program

    cfg = small_config("3gen")
    keys = K.make_keys(torch.Generator().manual_seed(3), cfg)
    held = {}
    for form in ("fblock", "fbstream"):
        params = program.registry_params(cfg)
        ck = keys3gen.cloud_key_from_samples(params, keys.bk.numpy().astype(np.int64),
                                             program._table_limbs(keys.ks), 2, (form,), "cpu")
        key = ck.bk_fb if form == "fblock" else ck.bk_fb_sel
        held[form] = key.numel() * key.element_size()
    w = workcount.rotate(cfg, 8)
    steps, N, R, C = 32, 64, 4, 2
    key_bytes = steps * R * C * N * 4
    assert w.nbytes == key_bytes + 4 * (8 * steps + 2 * 8 * C * N)
    assert key_bytes <= min(held.values())
    assert held["fblock"] != held["fbstream"]
