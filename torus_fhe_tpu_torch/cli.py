"""File-based CLI: the reference's cloud/client workflow programs.

Port of torus_fhe_tpu/cli.py over the port's key and ciphertext files
(utils/serialize.py), which are the JAX package's: a file written by one CLI
is read by the other.

* ``keygen``  — write the secret and cloud keys.
* ``encrypt`` — bitwise-encrypt an integer.
* ``eval``    — a homomorphic word gate under the cloud key.
* ``decrypt`` — bitwise decryption with the secret key.
* ``convert`` — AND two ints, LWE -> ring-LWE, (3,5)-threshold decryption
  across the smudging sweep 0.0125 -> 1e-3.
* ``tlwetn``  — ring-LWE encrypt 32 bits, (t,p)-share the ring key, partial
  and final decryption across the sweep 0.0625 -> 1e-3.
* ``knn``     — encrypted KNN over a cardio-style CSV, single-key or k-party
  multikey, with the threshold-decryption tail.

Usage: ``python -m torus_fhe_tpu_torch [--device cpu] <command> ...`` (see
--help per command). Everything runs on the card unless ``--device`` names
another device; seeds seed a ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _forms(arg: str):
    """The bootstrapping-key forms of a comma-separated ``--forms``, or None
    (with the reason on stderr) for a name that is not a form."""
    from .boot.bootstrap import FORMS

    forms = tuple(arg.split(","))
    if set(forms) - set(FORMS):
        print(f"forms {arg}: the bootstrapping-key forms are {', '.join(FORMS)}", file=sys.stderr)
        return None
    return forms


def _keygen(args) -> int:
    from .boot import api
    from .core.params import PARAMETER_REGISTRY
    from .utils import serialize

    forms = _forms(args.forms)
    if forms is None:
        return 2
    params = PARAMETER_REGISTRY[args.params]()
    t0 = time.time()
    sk, ck = api.make_key_pair(_gen(args.seed), params, device=args.device, forms=forms)
    serialize.save_secret_key(args.secret, sk)
    serialize.save_cloud_key(args.cloud, ck)
    print(f"keygen({args.params}, forms={args.forms}) -> {args.secret}, {args.cloud} "
          f"[{time.time() - t0:.1f}s]")
    return 0


def _encrypt(args) -> int:
    from .circuits import words
    from .utils import serialize

    sk = serialize.load_secret_key(args.secret, device=args.device)
    ct = words.int_encrypt(_gen(args.seed), sk, args.value, args.bits)
    serialize.save_lwe(args.out, ct, sk.params)
    print(f"encrypt({args.value}, {args.bits} bits) -> {args.out}")
    return 0


def _eval(args) -> int:
    from .boot import gates
    from .utils import serialize

    forms = _forms(args.forms)
    if forms is None:
        return 2
    ck = serialize.load_cloud_key(args.cloud, forms=forms, device=args.device)
    a = serialize.load_lwe(args.a, device=args.device)
    b = serialize.load_lwe(args.b, device=args.device)
    op = {"and": gates.gate_and, "or": gates.gate_or, "xor": gates.gate_xor,
          "nand": gates.gate_nand, "nor": gates.gate_nor, "xnor": gates.gate_xnor}[args.op]
    t0 = time.time()
    out = op(ck, a, b)
    serialize.save_lwe(args.out, out, ck.params)
    print(f"eval({args.op}) -> {args.out} [{time.time() - t0:.1f}s]")
    return 0


def _decrypt(args) -> int:
    from .circuits import words
    from .utils import serialize

    sk = serialize.load_secret_key(args.secret, device=args.device)
    ct = serialize.load_lwe(args.infile, device=args.device)
    print(int(words.int_decrypt(sk, ct, args.bits)))
    return 0


def _convert(args) -> int:
    """AND two ints, embed the word in ring-LWE under the ring-read key,
    and (3,5)-threshold-decrypt it bit by bit across the bound sweep."""
    from .boot import gates
    from .circuits import words
    from .rlwe import RLweSample
    from .threshold import convert as tconv
    from .threshold import decrypt as tdec
    from .threshold import shares as tsh
    from .utils import serialize

    sk = serialize.load_secret_key(args.secret, device=args.device)
    ck = serialize.load_cloud_key(args.cloud, device=args.device)
    bits = args.bits
    ca = words.int_encrypt(_gen(args.seed), sk, args.x, bits)
    cb = words.int_encrypt(_gen(args.seed + 1), sk, args.y, bits)
    t0 = time.time()
    cand = gates.gate_and(ck, ca, cb)  # every bit position in one batch
    want = (args.x & args.y) & ((1 << bits) - 1)
    direct = int(words.int_decrypt(sk, cand, bits))
    print(f"AND: expected {want}, direct decrypt {direct} [{time.time() - t0:.1f}s]")

    rkey = tconv.tlwe_key_from_lwe_key(sk.key)
    repo = tsh.share_secret_streaming(rkey.key, 3, 5, _gen(args.seed + 2))
    ring = tconv.tlwe_from_lwe(cand)  # (bits, 2, n)
    subset = [1, 2, 4]
    smudge = _gen(args.seed + 3)
    bound = 0.0125
    ok = True
    while bound > 1e-3:
        got = 0
        for i in range(bits):
            plain = tdec.threshold_decrypt(RLweSample(ring.a[i]), repo, subset, bound, smudge)
            got |= int(plain[0].item() > 0) << i  # the sign of coefficient 0
        ok = ok and got == want
        print(f"threshold bound={bound:<8g} subset={subset} -> {got} "
              f"[{'OK' if got == want else 'WRONG'}]")
        bound /= 2
    return 0 if ok and direct == want else 1


def _tlwetn(args) -> int:
    """(t,p) ring sharing and threshold decryption of a 32-bit message."""
    from .core.params import RLweParams
    from .rlwe import rlwe_encrypt, rlwe_keygen, rlwe_phase
    from .threshold import decrypt as tdec
    from .threshold import shares as tsh

    t, p = args.t, args.p
    ids = sorted(set(args.ids))
    if len(ids) < t:
        print(f"need at least {t} unique party ids, got {ids}", file=sys.stderr)
        return 2
    device = args.device
    params = RLweParams(polynomial_degree=1024, mask_size=2, bits=32)
    rkey = rlwe_keygen(_gen(args.seed), params, device=device)
    msg = args.value & 0xFFFFFFFF
    mu = tdec.encode_bits(msg, params.polynomial_degree, device=device)
    ct = rlwe_encrypt(_gen(args.seed + 1), mu, 0.001, rkey, params, device=device)
    print(f"message {msg}, direct decrypt {tdec.decode_bits(rlwe_phase(ct, rkey))}")

    t0 = time.time()
    repo = tsh.share_secret_streaming(rkey.key, t, p, _gen(args.seed + 2))
    print(f"shareSecret2({t},{p}) [{time.time() - t0:.2f}s]")
    smudge = _gen(args.seed + 3)
    bound = 0.0625
    while bound > 1e-3:
        t1 = time.time()
        partials = tdec.partial_decrypt(ct, repo.subset_shares(ids), bound, smudge)
        got = tdec.decode_bits(tdec.final_decrypt(ct, partials))
        print(f"bound={bound:<8g} parties={ids[:t]} -> {got} "
              f"[{'OK' if got == msg else 'WRONG'}] [{time.time() - t1:.2f}s]")
        bound /= 2
    return 0


def _knn(args) -> int:
    """Encrypted KNN over a cardio-style CSV, single-key or k-party
    multikey, with the (3,5)-threshold-decryption tail on each decision."""
    import json

    from .core.params import PARAMETER_REGISTRY

    if args.parties > 1:
        from .apps import mk_knn
        from .core.params import test_parameters_3gen

        params = (test_parameters_3gen(parties=args.parties, n=16, N=64) if args.tiny
                  else PARAMETER_REGISTRY[f"mk_{args.parties}party_3gen"]())
        res = mk_knn.run_mk_pipeline(
            _gen(args.seed), params, args.parties, args.csv, k=args.k, width=args.width,
            train_rows=args.train_rows, test_rows=args.test_rows, scale_shift=args.shift,
            threshold_tail=not args.no_tail, device=args.device)
    else:
        from .apps import knn
        from .boot import api
        from .core.params import test_parameters

        params = test_parameters(n=16, N=64) if args.tiny else PARAMETER_REGISTRY[args.params]()
        sk, ck = api.make_key_pair(_gen(args.seed), params, device=args.device)
        res = knn.run_pipeline(
            _gen(args.seed + 1), sk, ck, args.csv, k=args.k, width=args.width,
            train_rows=args.train_rows, test_rows=args.test_rows, scale_shift=args.shift,
            with_threshold_tail=not args.no_tail)
    print(json.dumps(res))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torus_fhe_tpu_torch", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the keys and ciphertexts (default: the current CUDA "
                         "device; 'cpu' runs the plain versions on the CPU)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("keygen", help="generate secret + cloud keys")
    k.add_argument("--params", default="tfhe_128_tpu")
    k.add_argument("--secret", default="secret.key.npz")
    k.add_argument("--cloud", default="cloud.key.npz")
    k.add_argument("--seed", type=int, default=0)
    k.add_argument("--forms", default="fblock",
                   help="comma-separated bootstrapping-key forms to build: fblock (the "
                        "F-block key, the Hopper kernel's route) and/or conv (the packed "
                        "kernels, the scan route); the saved key is compact either way and "
                        "eval rebuilds its forms on load")
    k.set_defaults(fn=_keygen)

    e = sub.add_parser("encrypt", help="bitwise-encrypt an integer")
    e.add_argument("value", type=int)
    e.add_argument("--secret", default="secret.key.npz")
    e.add_argument("--bits", type=int, default=32)
    e.add_argument("--out", default="ct.npz")
    e.add_argument("--seed", type=int, default=1)
    e.set_defaults(fn=_encrypt)

    v = sub.add_parser("eval", help="homomorphic gate on encrypted words")
    v.add_argument("op", choices=["and", "or", "xor", "nand", "nor", "xnor"])
    v.add_argument("a")
    v.add_argument("b")
    v.add_argument("--cloud", default="cloud.key.npz")
    v.add_argument("--out", default="out.npz")
    v.add_argument("--forms", default="fblock",
                   help="comma-separated bootstrapping-key forms to rebuild from the key "
                        "file: fblock and/or conv (the route follows the form: "
                        "boot/bootstrap.set_rotate_backend's 'auto')")
    v.set_defaults(fn=_eval)

    d = sub.add_parser("decrypt", help="decrypt an integer word")
    d.add_argument("infile")
    d.add_argument("--secret", default="secret.key.npz")
    d.add_argument("--bits", type=int, default=32)
    d.set_defaults(fn=_decrypt)

    c = sub.add_parser("convert", help="bin/convert scenario")
    c.add_argument("x", type=int)
    c.add_argument("y", type=int)
    c.add_argument("--secret", default="secret.key.npz")
    c.add_argument("--cloud", default="cloud.key.npz")
    c.add_argument("--bits", type=int, default=32)
    c.add_argument("--seed", type=int, default=10)
    c.set_defaults(fn=_convert)

    kn = sub.add_parser("knn", help="bin/KNN_medical_data scenario "
                                    "(single-key or k-party multikey)")
    kn.add_argument("csv", help="cardio-style CSV (id, features..., label)")
    kn.add_argument("--parties", type=int, default=1,
                    help=">1 runs the multikey pipeline (apps/mk_knn)")
    kn.add_argument("--k", type=int, default=5)
    kn.add_argument("--width", type=int, default=16)
    kn.add_argument("--shift", type=int, default=4)
    kn.add_argument("--train-rows", type=int, default=5)
    kn.add_argument("--test-rows", type=int, default=1)
    kn.add_argument("--params", default="tfhe_128_tpu_fast")
    kn.add_argument("--tiny", action="store_true", help="tiny insecure parameters (smoke)")
    kn.add_argument("--no-tail", action="store_true",
                    help="skip the (3,5)-threshold-decryption tail")
    kn.add_argument("--seed", type=int, default=30)
    kn.set_defaults(fn=_knn)

    tn = sub.add_parser("tlwetn", help="bin/tlwetn scenario")
    tn.add_argument("t", type=int)
    tn.add_argument("p", type=int)
    tn.add_argument("ids", type=int, nargs="+")
    tn.add_argument("--value", type=int, default=13452)
    tn.add_argument("--seed", type=int, default=20)
    tn.set_defaults(fn=_tlwetn)

    args = ap.parse_args(argv)
    from .core.device import resolve_device

    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
