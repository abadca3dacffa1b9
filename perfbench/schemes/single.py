"""The single-key scheme (``scheme`` "single"): the TFHE library's gate
bootstrapping over one key, on the 32-bit torus.

Key material: TGSW encryptions of the LWE key bits under the RLWE key and
the keyswitch table from the extracted RLWE key to the LWE key. The gate
bootstrap: mod-switch, the CMux chain of n steps, extract, keyswitch.
"""

from __future__ import annotations

import torch

from ..keys import Keys, binary, gaussian, keyswitch_table, negacyclic_product, uniform
from ..reference import MU, Gates, blind_rotate, extract, keyswitch_deltas, mod_switch, wrap32


def make_keys(gen: torch.Generator, cfg: dict) -> Keys:
    """TGSW encryptions of the LWE key bits under the RLWE key (rows (level,
    polynomial): a zero encryption with bit * 2^(32 - (level+1) lb) on
    polynomial j, coefficient 0), and the keyswitch table from the extracted
    RLWE key to the LWE key."""
    p = cfg["params"]
    n, N, k = p["lwe_size"], p["rlwe_polynomial_degree"], p["rlwe_mask_size"]
    l, lb, C = p["bs_decomp_length"], p["bs_log2_base"], k + 1
    if p.get("bk_drop_limbs", 0) or p["rlwe_bits"] != 32:
        raise ValueError("the single-key reference takes a 32-bit set with no rounded body")
    s_lwe, s_rlwe = binary(gen, (n,)), binary(gen, (k, N))
    mask = uniform(gen, (n, l, C, k, N))
    body = gaussian(gen, p["bs_noise_stddev"], (n, l, C, N))
    for j in range(k):
        body = body + negacyclic_product(mask[:, :, :, j], s_rlwe[j])
    bk = torch.cat([mask, wrap32(body)[:, :, :, None]], dim=3)  # (n, l, C, C, N)
    gadget = 1 << (32 - lb * torch.arange(1, l + 1, device=s_lwe.device))
    for j in range(C):
        bk[:, :, j, j, 0] += s_lwe[:, None] * gadget
    ks = keyswitch_table(gen, s_rlwe.reshape(-1), s_lwe, p["ks_decomp_length"],
                         p["ks_log2_base"], p["ks_noise_stddev"])
    return Keys(s_lwe[None], s_rlwe[None], wrap32(bk), ks)


class Reference(Gates):
    """The plain gate bootstrap over the raw key: a (S, n), b (S,) in, the
    switched sample a (S, n), b (S,) out."""

    def __init__(self, cfg: dict, keys: Keys, digits_dropped: int = 0):
        p = cfg["params"]
        self.N, self.n = p["rlwe_polynomial_degree"], p["lwe_size"]
        self.l, self.lb = p["bs_decomp_length"], p["bs_log2_base"]
        self.t, self.ks_lb = p["ks_decomp_length"], p["ks_log2_base"]
        self.key = keys.bk
        self.table = keys.ks.reshape(-1, keys.ks.shape[-1]).to(torch.float64)
        self.digits_dropped = digits_dropped

    def _bootstrap(self, a, b):
        acc = blind_rotate(mod_switch(a, self.N), mod_switch(b, self.N), MU, self.key, self.l,
                           self.lb, self.digits_dropped)
        ea, eb = extract(acc)
        deltas = keyswitch_deltas(ea, self.table, self.t, self.ks_lb)
        return wrap32(-deltas[:, :self.n]), wrap32(eb - deltas[:, self.n])
