"""A dry run of the mesh paths at tiny insecure parameters.

Port of ``dryrun_multichip`` in the repository's ``__graft_entry__.py``:
the batch-sharded gate, the party-sharded threshold decryption and the
party-pipelined multikey NAND, each checked. ``devices`` may repeat a device:
``[torch.device("cpu")] * 8`` runs the plain versions on the CPU, and
``[torch.device("cuda", 0)] * 8`` the kernels on one card. After
``mesh.init_distributed`` every rank calls it with its own devices and the
checks run across the ranks (the mesh is every rank's devices in rank order).

    python -m torus_fhe_tpu_torch.parallel.dryrun [cpu|cuda] [count]
    torchrun --nproc-per-node 2 -m torus_fhe_tpu_torch.parallel.dryrun cpu 4

``count`` is the number of mesh slots in all, split evenly over the
processes; under torchrun the CPU takes gloo, the card NCCL (one process a
card).
"""

from __future__ import annotations

import sys
from typing import Sequence

import torch

from ..boot import api, gates
from ..core.params import test_parameters, test_parameters_3gen
from ..mk import gates3gen, keys3gen, samples
from ..rlwe import rlwe_encrypt, rlwe_keygen
from ..threshold import decrypt as tdec
from ..threshold import shares as tsh
from . import mesh as pmesh
from . import mk_pipeline, sharded


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(devices: Sequence) -> None:
    """Batch-sharded gate_and over every device (decrypt-checked); from 2
    devices the party-sharded threshold decryption (word-equal to the
    sequential partial/final pair at sd=0, and decoding at sd=1e-3); from 4
    devices the compact-key pipelined NAND at 4 parties (decrypt-checked).
    Raises on the first failure."""
    devices = [torch.device(d) for d in devices]
    m = pmesh.make_mesh(n_party=1, devices=devices)
    k = m.shape[pmesh.BATCH_AXIS]
    home = m.home()

    params = test_parameters(n=16, N=64)
    sk, ck = api.make_key_pair(torch.Generator().manual_seed(7), params, device=home)
    B = 4 * k
    xs = torch.arange(B, device=home) % 2 == 0
    ys = torch.arange(B, device=home) % 3 == 0
    cx = api.encrypt(torch.Generator().manual_seed(1), sk, xs)
    cy = api.encrypt(torch.Generator().manual_seed(2), sk, ys)
    out = pmesh.run_batch_sharded(gates.gate_and, pmesh.replicate_cloud_key(ck, m),
                                  pmesh.shard_lwe_batch(cx, m), pmesh.shard_lwe_batch(cy, m),
                                  mesh=m)
    _check(torch.equal(api.decrypt(sk, out), xs & ys), "batch-sharded gate_and decrypts wrong")

    if k >= 2:
        m2 = pmesh.make_mesh(n_batch=1, n_party=k, devices=devices)
        rp = params.rlwe
        g = torch.Generator().manual_seed(11)
        rk = rlwe_keygen(g, rp, device=home)
        repo = tsh.share_secret(rk.key, 3, 5, g)
        mu = tdec.encode_bits(0xBEEF, rp.polynomial_degree, n_bits=16, device=home)
        ct = rlwe_encrypt(g, mu, 1e-3, rk, rp, device=home)
        sh = repo.subset_shares([1, 2, 4])
        signs = [-1] + [1] * (sh.shape[0] - 1)
        got = sharded.threshold_decrypt_sharded(ct.a, sh, signs, 0.0,
                                                torch.Generator().manual_seed(14), m2)
        ref = tdec.final_decrypt(ct, tdec.partial_decrypt(ct, sh, 0.0,
                                                          torch.Generator().manual_seed(14)))
        _check(torch.equal(got, ref), "sharded threshold decryption != the sequential pair")
        _check(tdec.decode_bits(got, n_bits=16) == 0xBEEF, "threshold decode failed")
        got_sm = sharded.threshold_decrypt_sharded(ct.a, sh, signs, 1e-3,
                                                   torch.Generator().manual_seed(15), m2)
        _check(tdec.decode_bits(got_sm, n_bits=16) == 0xBEEF,
               "smudged threshold decode failed at bound 1e-3")

    if k >= 4:
        parties = 4
        p3 = test_parameters_3gen(parties=parties, n=6, N=64)
        g = torch.Generator().manual_seed(300)
        sks = [keys3gen.mk_party_keygen(g, p3, device=home) for _ in range(parties)]
        ck3 = keys3gen.mk_cloud_keygen(g, sks, p3, device=home, forms=("fbstream",),
                                       keep_samples=True)
        m3 = pmesh.make_mesh(n_batch=1, n_party=parties, devices=devices)
        sel = mk_pipeline.build_sharded_mk_sel(ck3.bk_samples, p3, parties, m3)
        keys = [s.lwe for s in sks]
        xs3 = torch.arange(8, device=home) % 2 == 0
        ys3 = torch.arange(8, device=home) % 3 == 0
        t3 = gates3gen.mk_gate_nand_wb(ck3, samples.mk_encrypt(g, keys, xs3, p3),
                                       samples.mk_encrypt(g, keys, ys3, p3))
        out3 = mk_pipeline.mk_bootstrap_pipelined(ck3, sel, gates3gen.MU, t3, m3,
                                                  microbatches=4)
        _check(torch.equal(samples.mk_decrypt(keys, out3), ~(xs3 & ys3)),
               "pipelined multikey NAND decrypts wrong")


if __name__ == "__main__":
    kind = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    count = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    spread = pmesh.init_distributed(backend="gloo" if kind == "cpu" else None)
    world = torch.distributed.get_world_size() if spread else 1
    if count % world:
        raise SystemExit(f"{count} slots do not split over {world} processes")
    dev = pmesh.rank_device() if kind == "cuda" else torch.device(kind)
    try:
        dryrun_multichip([dev] * (count // world))
        print(f"dryrun_multichip({kind} x {count}, rank {pmesh.process_rank()} of {world}) OK")
    finally:
        if spread:
            torch.distributed.destroy_process_group()
