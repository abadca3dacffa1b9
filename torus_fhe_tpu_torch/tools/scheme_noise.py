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
import sys

HERE = os.path.dirname(os.path.realpath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# run as a script, this file's directory stands first on sys.path, where
# tools/profile.py would stand in for the standard library's profile module
# (cProfile imports it, and torch._dynamo imports cProfile)
sys.path[:] = [p for p in sys.path if os.path.realpath(p or os.curdir) != HERE]
if not any(os.path.isdir(os.path.join(p, "torus_fhe_tpu_torch")) for p in sys.path if p):
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torus_fhe_tpu_torch import mk  # noqa: E402
from torus_fhe_tpu_torch.core import params as P  # noqa: E402
from torus_fhe_tpu_torch.core.torus import noise_calc  # noqa: E402
from torus_fhe_tpu_torch.mk import ccs, kms  # noqa: E402
from torus_fhe_tpu_torch.ops import hostmath, poly  # noqa: E402
from torus_fhe_tpu_torch.tools import smi_line  # noqa: E402


def ccs_noise_std(params: P.SchemeParamsCCS, ck=None, sks=None) -> float:
    """The output-noise std of a CCS gate predicted from its parameters
    (and, given the cloud key ``ck`` and the parties' secret keys ``sks``,
    from that key's own public-key noise and key bits).

    Step s of the party-major CMux chain belongs to party i and adds the
    phase error of one hybrid product on x = (X^a - 1) * ACC. Mask j of ACC
    is zero until party j's first step has run, so a step of party i sees
    the masks j <= i (j < i at its first step): ``active`` (mask, step)
    pairs in all. Each active mask j gives two terms of one size:
    r (*) <g(x_j), e_j> (r the binary randomness of the step's
    uni-encryption, e_j party j's public-key noise) and s_j (*) <g(x_j), e_d>
    (s_j party j's binary ring key, e_d the noise of the step's d1). The
    balanced digits of a uniform x have mean -1/2 and variance
    (Bg^2 - 1)/12, and r and s_j have mean 1/2, so with Q = 1 (*) 1 (the
    all-ones polynomial squared; its squared coefficients sum to
    (N^3 + 2N)/3 =: q2) each term splits into

        zero-mean parts, independent between steps:  N^2 l var ((Bg^2-1)/24 + 1/16)
        a mean part, -1/4 Q (*) (sum over levels of e):   l var q2 / 16

    per active pair, var the bootstrapping-key noise variance. The mean
    part of the s_j term has the fresh e_d of its step, so it adds once per
    pair. That of the r term has the fixed e_j: the steps up to the next
    key bit 1 add it to ACC with no rotation between them, so it adds
    coherently inside each such run, and a random rotation (a uniform a_t)
    decorrelates the runs. With uniform key bits a run holds a step and
    the next step with probability 1/2, the one after with 1/4, ..., so the
    expected sum over pairs of steps is 3 times the diagonal. Given the key,
    the coherent part is exact: e_j = b_j - s_j (*) a from the public keys,
    F_j = Q (*) (sum over levels of e_j), and per run the squared norm of
    the sum of its steps' F over the N coefficient positions a rotation
    picks (``_coherent_var``). Q's spectrum puts ~99% of each F in one
    complex frequency, so this part varies widely from key to key (at 16
    parties the expectation alone left a quarter of the keys outside
    x[0.75, 1.5] in a simulation of that spectrum). The keyswitch adds its
    table noise on the non-zero digits of each party's N*l_ks digits. Left
    out: the noise of f0 and the d1 and f0 terms that no secret multiplies
    (2/N of the above), and the gadget rounding (below 0.1% at the registry
    sets)."""
    Pn = ck.parties if ck is not None else params.max_parties
    n, N = params.lwe_size, params.rlwe_polynomial_degree
    l, Bg = params.bs_decomp_length, 1 << params.bs_log2_base
    var = params.bs_noise_stddev**2
    active = n * Pn * (Pn + 1) // 2 - Pn
    zero_mean = 2 * active * N * N * l * var * ((Bg**2 - 1) / 24 + 1 / 16)
    mean_part = l * var * (N**3 + 2 * N) / 3 / 16
    fresh = (n * Pn * (Pn + 1) * (2 * Pn + 1) // 6 - Pn * Pn) * mean_part
    coherent = 3 * active * mean_part if ck is None else _coherent_var(ck, sks)
    base = 1 << params.ks_log2_base
    keyswitch = Pn * N * params.ks_decomp_length * (1 - 1 / base) * params.ks_noise_stddev**2
    return math.sqrt(zero_mean + fresh + coherent + keyswitch)


def _coherent_var(ck, sks) -> float:
    """The coherent part of ``ccs_noise_std`` on one key: each party's
    public-key noise from its public key, F_j = Q (*) (e_j summed over the
    levels) as floats of the torus, then over the runs of steps that end
    before a key bit 1, the squared norm of the sum of the runs' F (each
    step: F of its active masks) over 16 N (the mean part's 1/4, squared;
    a uniform coefficient position)."""
    params, P = ck.params, ck.parties
    n, N, bits = params.lwe_size, params.rlwe_polynomial_degree, params.rlwe_bits
    shared = poly.unpack_kernels_host(ck.sk_kern.cpu().numpy(), bits, 1)[..., 0, :]  # (l, N)
    pub = poly.unpack_kernels_host(ck.pk_kern.cpu().numpy(), bits, 1)[..., 0, :]  # (P, l, N)
    q = 2 * np.arange(1, N + 1, dtype=np.float64) - N  # Q = 1 (*) 1
    F = np.empty((P, N))
    for j, sk in enumerate(sks):
        with np.errstate(over="ignore"):
            e = pub[j] - hostmath.negacyclic_polymul_host(sk.rlwe.key[0].cpu().numpy(), shared, bits)
        e = e.astype(np.int32).astype(np.float64).sum(0) / 2.0**bits
        full = np.convolve(q, e)  # negacyclic: X^N = -1
        F[j] = full[:N] - np.append(full[N:], 0.0)
    bit = np.concatenate([sk.lwe.key.cpu().numpy() for sk in sks]).astype(np.int64)
    run = np.cumsum(bit)  # a step with key bit 1 rotates what came before it: a new run
    owner = np.repeat(np.arange(P), n)
    act = (np.arange(P)[None, :] <= owner[:, None]).astype(np.float64)  # (P*n, P)
    act[np.arange(P) * n, np.arange(P)] = 0.0  # a party's first step: its mask is still zero
    C = np.zeros((run[-1] + 1, P))
    np.add.at(C, run, act)
    return float(((C @ (F @ F.T)) * C).sum() / (16 * N))


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
    err = noise_calc(ideal, phase).double()  # the short way round the torus
    return wrong, err.abs().max().item(), err.std().item(), int((err.abs() >= bound).sum())


def measure(ck, sks, seed: int, batch: int) -> dict:
    """One NAND of ``batch`` gates over all four input pairs on the cloud
    key ``ck`` (CCS or KMS; the parties' secret keys ``sks``), the inputs
    from ``seed``: its noise record (CCS: the std over ``ccs_noise_std``'s
    expectation over keys and over its value on this key)."""
    params, device = ck.params, sks[0].lwe.key.device
    scheme = ccs if isinstance(params, P.SchemeParamsCCS) else kms
    gen = torch.Generator().manual_seed(seed + 1)
    lwe = [sk.lwe for sk in sks]
    pairs = torch.from_numpy(np.random.default_rng(seed).permutation(np.arange(batch) % 4))
    x, y = (pairs >= 2).to(device), (pairs % 2 == 1).to(device)
    out = scheme.mk_gate_nand(ck, mk.mk_encrypt(gen, lwe, x, params),
                              mk.mk_encrypt(gen, lwe, y, params))
    wrong, err_max, std, over = phase_error(out, lwe, ~(x & y))
    rec = {"seed": seed, "batch": batch, "std": std, "max": err_max, "over_1_16": over,
           "wrong": wrong}
    if scheme is ccs:
        rec["std_over_prediction"] = std / ccs_noise_std(params)
        rec["std_over_key_prediction"] = std / ccs_noise_std(params, ck, sks)
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
    from torus_fhe_tpu_torch.tools import perf_comp  # the keygen workers

    device = torch.device("cuda")
    print(smi_line(device), flush=True)

    jobs = []
    for name in args.sets.split(","):
        params = P.PARAMETER_REGISTRY[name]()
        field = "bs_noise_stddev" if isinstance(params, P.SchemeParamsCCS) else "uni_noise_stddev"
        params = dataclasses.replace(params, **{field: getattr(params, field) * args.noise_scale})
        jobs += [(f"{name}_{k}", params, args.seed + k, ("fb",), None) for k in range(args.keys)]
    try:  # every key's host keygen in a worker process of its own, all at once
        perf_comp.start_keygens(jobs, prefix="scheme_noise_")
        for job, params, seed, _, _ in jobs:
            ck, sks, made, _, _ = perf_comp.take_key(job, params, device, 3600.0)
            rec = measure(ck, sks, seed, args.batch)
            print(json.dumps({"set": job.rsplit("_", 1)[0], "noise_scale": args.noise_scale,
                              "keygen_s": made["keygen_s"], **rec}), flush=True)
            del ck, sks
    finally:
        perf_comp.stop_keygens()
    return 0


if __name__ == "__main__":
    sys.exit(main())
