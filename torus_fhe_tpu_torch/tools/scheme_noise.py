#!/usr/bin/env python3
"""Measures the output noise of the CCS and KMS multikey NAND gates
(mk/ccs.py, mk/kms.py) at a registry set, over several keys, on one NVIDIA
GPU.

Run it as a script from the root of the repository, e.g.
``python3 torus_fhe_tpu_torch/tools/scheme_noise.py --sets mk_2party_ccs
--keys 4``. Per key it makes the party keys and the cloud key from the seed
``--seed + key``, NANDs ``--batch`` gates over all four input pairs, and
prints one JSON line: the std and the largest |phase - ideal| of the outputs
(fractions of the torus), how many reach 1/16, how many decrypt wrong, and
for CCS the std over ``ccs_noise_std``'s prediction. ``--noise-scale``
multiplies the set's bootstrapping-key noise (CCS ``bs_noise_stddev``, KMS
``uni_noise_stddev``). The first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if not any(os.path.isdir(os.path.join(p, "torus_fhe_tpu_torch")) for p in sys.path if p):
    sys.path.insert(0, ROOT)

from torus_fhe_tpu_torch import mk  # noqa: E402
from torus_fhe_tpu_torch.core import params as P  # noqa: E402
from torus_fhe_tpu_torch.mk import ccs, kms  # noqa: E402


def ccs_noise_std(params: P.SchemeParamsCCS) -> float:
    """The output-noise std of a CCS gate predicted from its parameters, as
    a sum of independent terms. The blind rotate's dominant one is
    r (*) <g(x_j), e_j> in every hybrid product: the binary r of the
    uni-encryption (weight N/2) times party j's public-key noise contracted
    with l*N gadget digits of variance (Bg^2 + 2)/12, for each of the P
    parties j, over the P*n steps. The keyswitch adds its table noise on the
    non-zero digits of each party's N*l_ks digits. Left out: the other
    rotate terms (the noise of d1 and f0, the gadget rounding: under 1% of
    it at the registry sets), and the steps' covariance through the mean
    1/2 of r's coefficients (consecutive steps decompose rotations of one
    accumulator), which puts the measured std above this prediction."""
    Pn, n, N = params.max_parties, params.lwe_size, params.rlwe_polynomial_degree
    l, Bg = params.bs_decomp_length, 1 << params.bs_log2_base
    rotate = Pn * n * Pn * (N / 2) * l * N * (Bg**2 + 2) / 12 * params.bs_noise_stddev**2
    base = 1 << params.ks_log2_base
    keyswitch = Pn * N * params.ks_decomp_length * (1 - 1 / base) * params.ks_noise_stddev**2
    return math.sqrt(rotate + keyswitch)


def allowed_wrong(B: int, sigma: float) -> int:
    """The fewest wrong decryptions of B gates that gates of output-noise std
    ``sigma`` exceed with probability below 1e-6: a gate decrypts wrong when
    its error crosses the 1/8 between its ideal phase and the boundary."""
    p = math.erfc(0.125 / (sigma * math.sqrt(2))) / 2
    tail, w, pmf = 1.0, 0, (1 - p) ** B
    while True:
        tail -= pmf
        if tail < 1e-6:
            return w
        w += 1
        pmf *= (B - w + 1) / w * p / (1 - p)


def phase_error(out: mk.MKLweSample, keys, want: torch.Tensor, bound: float = 1 / 16):
    """(wrong decryptions, max |phase - ideal|, std of phase - ideal, count
    of |phase - ideal| >= ``bound``) of a gate output against the plain bits
    ``want``, as fractions of the torus."""
    phase = mk.mk_lwe_phase(out, keys)
    wrong = int((phase > 0).ne(want).sum())
    ideal = torch.where(want, ccs.MU, -ccs.MU).to(torch.int32)
    err = (phase - ideal).double() / 2.0**32  # int32 wrap: the short way round
    return wrong, err.abs().max().item(), err.std().item(), int((err.abs() >= bound).sum())


def measure(params, seed: int, batch: int, device) -> dict:
    """One key of ``params`` (CCS or KMS) from ``seed``, one NAND of
    ``batch`` gates over all four input pairs: its noise record."""
    scheme = ccs if isinstance(params, P.SchemeParamsCCS) else kms
    keygen = ccs.ccs_party_keygen if scheme is ccs else kms.kms_party_keygen
    cloud = ccs.ccs_cloud_keygen if scheme is ccs else kms.kms_cloud_keygen
    gen = torch.Generator().manual_seed(seed)
    sks = [keygen(gen, params, device=device) for _ in range(params.max_parties)]
    ck = cloud(gen, sks, params, device=device)
    keys = [sk.lwe for sk in sks]
    pairs = torch.from_numpy(np.random.default_rng(seed).permutation(np.arange(batch) % 4))
    x, y = (pairs >= 2).to(device), (pairs % 2 == 1).to(device)
    out = scheme.mk_gate_nand(ck, mk.mk_encrypt(gen, keys, x, params),
                              mk.mk_encrypt(gen, keys, y, params))
    wrong, err_max, std, over = phase_error(out, keys, ~(x & y))
    rec = {"seed": seed, "batch": batch, "std": std, "max": err_max, "over_1_16": over,
           "wrong": wrong}
    if scheme is ccs:
        rec["std_over_prediction"] = std / ccs_noise_std(params)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sets", default="mk_2party_ccs,mk_2party_kms",
                    help="registry names, comma-separated")
    ap.add_argument("--keys", type=int, default=3)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--noise-scale", type=float, default=1.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scheme_noise: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda")
    for name in args.sets.split(","):
        params = P.PARAMETER_REGISTRY[name]()
        field = "bs_noise_stddev" if isinstance(params, P.SchemeParamsCCS) else "uni_noise_stddev"
        params = dataclasses.replace(params, **{field: getattr(params, field) * args.noise_scale})
        for k in range(args.keys):
            rec = measure(params, args.seed + k, args.batch, device)
            print(json.dumps({"set": name, "noise_scale": args.noise_scale, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
