"""Statistical noise and wrong-decryption measurement harness.

Port of torus_fhe_tpu/utils/noise.py. Per parameter set it runs a batch of
trials of encrypt -> bootstrapped gate -> phase, and reports the torus noise
of the fresh and the bootstrapped ciphertexts (``core.torus.noise_calc``),
the wrong decryptions, the rounded-phase error classes of the next gate's
input (the reference's taxonomy: its mod-switch-rounded phase against the
(0, 1/4) band), the key sizes and the gate's wall time; for the 3gen
multikey scheme also the noise before the per-party keyswitch. The report's
fields, its JSON and its files are the JAX package's, so the port's reports
read like the committed ``measurements/log__*.log`` and ``noises__*.dat``.

Each entry point has two halves: keygen and sampling from a
``torch.Generator`` (child generators seeded from one draw of it, one per
role, the way the JAX package folds its key: party p's keys from child
100 + p, the cloud key from child 7), then a report step
(``report_single_key``, ``report_multikey``) that takes keys, messages and
ciphertexts and returns the ``NoiseReport``. A caller that holds keys
already (JAX's keys through ``bridge.py``, or keys it made for other work)
calls the report step alone. ``device=None`` is the card
(core/device.resolve_device); a CPU caller says ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.torus import decode_message, encode_message, noise_calc


@dataclasses.dataclass
class NoiseReport:
    trials: int
    fresh_noise_std: float
    fresh_noise_max: float
    boot_noise_std: float
    boot_noise_max: float
    wrong_decryptions: int
    wrong_indices: list
    bk_bytes: int
    ks_bytes: int
    bootstrap_wall_s: float
    # the mod-switch-rounded phase of the next gate's input, in the
    # expected-positive frame, over ALL trials: > 1/4 is past the test
    # vector's half (a wrong phase, still a right decryption), < 0 crossed
    # the sign boundary (a wrong phase and a wrong decryption)
    wrong_phase_gt_quarter: int = 0
    wrong_phase_lt_zero: int = 0
    boot_noises: np.ndarray | None = None  # per trial, bootstrapped
    fresh_noises: np.ndarray | None = None
    # 3gen: the extracted sample before the per-party keyswitch, under the
    # summed extracted ring keys: the rotate's noise without the keyswitch's
    pre_ks_noise_std: float | None = None
    pre_ks_noise_max: float | None = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("boot_noises", None)
        d.pop("fresh_noises", None)
        return json.dumps(d)

    def write_artifacts(self, directory: str, tag: str) -> None:
        """The reference's result files: ``noises__<tag>.dat``, one
        bootstrapped noise a line, and ``log__<tag>.log``, the report's JSON
        and each wrong decryption with its class."""
        os.makedirs(directory, exist_ok=True)
        if self.boot_noises is not None:
            with open(os.path.join(directory, f"noises__{tag}.dat"), "w") as f:
                for v in np.asarray(self.boot_noises).ravel():
                    f.write(f"{float(v):.17g}\n")
        with open(os.path.join(directory, f"log__{tag}.log"), "w") as f:
            f.write(f"# {tag}: {self.to_json()}\n")
            for idx, cls in zip(self.wrong_indices, self.wrong_classes):
                noise = (float(np.asarray(self.boot_noises).ravel()[idx])
                         if self.boot_noises is not None else float("nan"))
                f.write(f"wrong_decryption trial={idx} class={cls} "
                        f"noise={noise:.6g}\n")

    wrong_classes: list = dataclasses.field(default_factory=list)


def _rounded_phase_classes(phase_pos: np.ndarray, wrong):
    """The classes over ALL trials of the rounded phase in the
    expected-positive frame, against the (0, 1/4) band. Returns
    (n_gt_quarter, n_lt_zero, the class of each wrong index)."""
    n_gt = int(np.sum(phase_pos > 0.25))
    n_lt = int(np.sum(phase_pos < 0.0))
    classes = []
    for idx in wrong:
        p = float(phase_pos[idx])
        classes.append("rounded_phase_gt_quarter" if p > 0.25
                       else "rounded_phase_lt_zero" if p < 0.0
                       else "boot_noise")  # in band: the bootstrap made the wrong bit
    return n_gt, n_lt, classes


def _round_mod_switch(a: torch.Tensor, b: torch.Tensor, N: int):
    """Mask and body rounded to the 2N message space and mapped back to the
    torus (the reference's re-encode of the mod-switched sample)."""
    return (encode_message(decode_message(a, 2 * N), 2 * N, a.dtype),
            encode_message(decode_message(b, 2 * N), 2 * N, b.dtype))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _wall(fn, device: torch.device):
    """(fn's result, wall seconds of fn, synchronised on a CUDA device)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _children(generator: torch.Generator):
    """child(i): a generator on ``generator``'s device seeded from one draw
    of ``generator`` and ``i``, the same for the same draw."""
    base = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))

    def child(i: int) -> torch.Generator:
        seed = int(np.random.SeedSequence((base, i)).generate_state(1, np.uint64)[0])
        return torch.Generator(device=generator.device).manual_seed(seed)

    return child


def _bits(generator: torch.Generator, trials: int) -> torch.Tensor:
    """Fair coin flips on the generator's device."""
    return torch.rand((trials,), generator=generator, device=generator.device) < 0.5


def _next_gate_classes(out, out_true, phase_of, want: np.ndarray, wrong, N: int):
    """The rounded-phase classes of the next gate's combination of TWO
    bootstrapped inputs, NAND(out, out_true) = !want, whose ideal phase is
    +-1/8 for both values (one operand twice would sit at 3/8 half the
    time), mod-switch rounded to 2N; ``phase_of`` decrypts a sample of
    out's type to its phase."""
    ra, rb = _round_mod_switch(-(out.a + out_true.a), encode_message(
        1, 8, device=out.b.device) - (out.b + out_true.b), N)
    phase_r = _host(phase_of(type(out)(ra, rb)))
    phase_pos = np.where(~want, 1.0, -1.0) * (phase_r.astype(np.float64) / 2.0**32)
    return _rounded_phase_classes(phase_pos, wrong)


def _report(fresh: np.ndarray, boot: np.ndarray, wrong: np.ndarray, bk_bytes: int,
            ks_bytes: int, wall: float, classes: tuple, pre=None) -> NoiseReport:
    """The report of per-trial fresh and bootstrapped noises, the wrong
    indices, (n_gt_quarter, n_lt_zero, classes) and the pre-keyswitch
    noises, if any; lists cut to 16 entries, as the JAX package does."""
    n_gt, n_lt, wrong_classes = classes
    return NoiseReport(len(boot), float(fresh.std()), float(np.abs(fresh).max()),
                       float(boot.std()), float(np.abs(boot).max()), int(wrong.size),
                       wrong.tolist()[:16], bk_bytes, ks_bytes, wall,
                       wrong_phase_gt_quarter=n_gt, wrong_phase_lt_zero=n_lt,
                       wrong_classes=wrong_classes[:16], boot_noises=boot, fresh_noises=fresh,
                       pre_ks_noise_std=None if pre is None else float(pre.std()),
                       pre_ks_noise_max=None if pre is None else float(np.abs(pre).max()))


def _pm_eighth(want: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """+1/8 where ``want``, else -1/8, on want's device."""
    return torch.where(want, encode_message(1, 8, dtype, want.device),
                       encode_message(-1, 8, dtype, want.device))


def measure_single_key(generator: torch.Generator, params, trials: int = 1000,
                       device=None) -> NoiseReport:
    """Single-key harness: a bootsAND of each message with an encryption of
    True, over ``trials`` messages, keys in the ``fblock`` form on
    ``device``."""
    from ..boot import api

    device = resolve_device(device)
    child = _children(generator)
    sk, ck = api.make_key_pair(child(1), params, device=device)
    msgs = _bits(child(2), trials).to(device)
    ct = api.encrypt(child(3), sk, msgs)
    true_ct = api.encrypt(child(9), sk, torch.ones((trials,), dtype=torch.bool, device=device))
    return report_single_key(sk, ck, msgs, ct, true_ct)


def report_single_key(sk, ck, msgs: torch.Tensor, ct, true_ct) -> NoiseReport:
    """The report of ``measure_single_key`` on given keys (``boot.api``'s
    SecretKey and CloudKey), messages (trials,) bool, their encryptions
    ``ct`` and encryptions of True ``true_ct``, all on one device."""
    from ..boot import gates
    from ..lwe import lwe_phase

    device = ct.b.device
    msgs = msgs.to(device)
    mu = _pm_eighth(msgs)
    fresh = _host(noise_calc(mu, lwe_phase(ct, sk.key)))
    out, wall = _wall(lambda: gates.gate_and(ck, ct, true_ct), device)
    phase = lwe_phase(out, sk.key)
    boot = _host(noise_calc(mu, phase))
    want = _host(msgs)
    wrong = np.nonzero(_host(phase > 0) != want)[0]
    classes = _next_gate_classes(out, gates.gate_and(ck, true_ct, true_ct),
                                 lambda x: lwe_phase(x, sk.key), want, wrong,
                                 ck.params.rlwe_polynomial_degree)
    bk = ck.bootstrap_key
    bk_bytes = (bk.kernels if bk.kernels is not None else bk.fb).nbytes
    return _report(fresh, boot, wrong, bk_bytes, ck.keyswitch_key.mat.nbytes,
                   wall, classes)


def _forms_3gen(params, parties: int, fast_form) -> tuple:
    """The JAX harness's choice: the fast form (``keys3gen.default_forms``:
    the expanded key up to 10 GiB, else the compact one; the exact lines at
    a wide-digit set) unless ``fast_form`` is False, which takes the exact
    route ``("conv",)``."""
    from ..mk import keys3gen

    if fast_form is None:
        fast_form = keys3gen.mk_fb_stream_supported(params)
    return keys3gen.default_forms(params, parties) if fast_form else ("conv",)


def measure_multikey(generator: torch.Generator, params, parties: int, trials: int = 1000,
                     scheme: str = "3gen", fast_form: bool | None = None,
                     cache_path: str | None = None, keygen_only: bool = False,
                     device=None) -> NoiseReport | None:
    """Multikey harness for the three schemes, ``scheme`` "3gen" | "ccs" |
    "kms": AND(m, True) at 3gen, NAND(m, True) at CCS and KMS.

    ``fast_form`` (3gen): the fast form the set supports (default), or with
    False the exact 64-bit route (``forms=("conv",)``): the chain over the
    raw samples, without the hi-word rounding of the key.

    ``cache_path`` (3gen): the cloud key's file (utils/serialize.py). A run
    loads it where it exists, else makes the key and writes it;
    ``keygen_only=True`` returns None after that. The party keys are remade
    from ``generator`` in every run, and pair with the loaded key when
    ``generator`` is seeded as it was when the file was written."""
    from .. import mk

    device = resolve_device(device)
    child = _children(generator)
    if scheme == "3gen":
        forms = _forms_3gen(params, parties, fast_form)
        sks = [mk.mk_party_keygen(child(100 + p), params, device=device) for p in range(parties)]
        ck = None
        if cache_path is not None and os.path.exists(cache_path):
            from . import serialize

            ck = serialize.load_mk_cloud_key(cache_path, forms=forms, device=device)
        if ck is None:
            ck = mk.mk_cloud_keygen(child(7), sks, params, device=device, forms=forms,
                                    keep_samples=cache_path is not None)
            if cache_path is not None:
                from . import serialize

                serialize.save_mk_cloud_key(cache_path, ck)
        if keygen_only:
            return None
    elif scheme in ("ccs", "kms"):
        from ..mk import ccs, kms

        party_keygen = ccs.ccs_party_keygen if scheme == "ccs" else kms.kms_party_keygen
        cloud_keygen = ccs.ccs_cloud_keygen if scheme == "ccs" else kms.kms_cloud_keygen
        sks = [party_keygen(child(100 + p), params, device=device) for p in range(parties)]
        ck = cloud_keygen(child(7), sks, params, device=device)
    else:
        raise ValueError(scheme)
    keys = [sk.lwe for sk in sks]
    msgs = _bits(child(1), trials).to(device)
    ct = mk.mk_encrypt(child(2), keys, msgs, params)
    true_ct = mk.mk_encrypt(child(3), keys, torch.ones((trials,), dtype=torch.bool,
                                                       device=device), params)
    return report_multikey(sks, ck, msgs, ct, true_ct, scheme)


def _multikey_gate(ck, scheme: str):
    from ..mk import ccs, gates3gen, kms

    if scheme == "3gen":
        return lambda a, b: gates3gen.mk_gate_and(ck, a, b)
    return lambda a, b: (ccs if scheme == "ccs" else kms).mk_gate_nand(ck, a, b)


def _multikey_bytes(ck, scheme: str) -> tuple:
    """(bootstrapping key bytes, keyswitch table bytes) of the key held: at
    3gen the rotate's form, at CCS and KMS every tensor but the tables."""
    if scheme == "3gen":
        bk = next(a for a in (ck.bk_fb, ck.bk_fb_sel) if a is not None)
        return bk.nbytes, ck.ks_mat.nbytes
    bk = sum(v.nbytes for k, v in vars(ck).items()
             if isinstance(v, torch.Tensor) and k != "ks_mats")
    return bk, ck.ks_mats.nbytes


def report_multikey(secret_keys, ck, msgs: torch.Tensor, ct, true_ct,
                    scheme: str = "3gen") -> NoiseReport:
    """The report of ``measure_multikey`` on given keys: the parties'
    secret keys (each with ``lwe`` and ``rlwe``), the cloud key of
    ``scheme``, messages (trials,) bool, their encryptions ``ct`` and
    encryptions of True ``true_ct``, all on one device."""
    from ..mk.samples import mk_lwe_phase

    device = ct.b.device
    keys = [sk.lwe for sk in secret_keys]
    gate = _multikey_gate(ck, scheme)
    msgs = msgs.to(device)
    fresh = _host(noise_calc(_pm_eighth(msgs), mk_lwe_phase(ct, keys)))
    out, wall = _wall(lambda: gate(ct, true_ct), device)
    want_t = msgs if scheme == "3gen" else ~msgs  # AND(m, 1) = m, NAND(m, 1) = !m
    phase = mk_lwe_phase(out, keys)
    boot = _host(noise_calc(_pm_eighth(want_t), phase))
    want = _host(want_t)
    wrong = np.nonzero(_host(phase > 0) != want)[0]

    pre = None
    if scheme == "3gen":
        pre = _pre_keyswitch_noise(secret_keys, ck, ct, true_ct, want_t)
    out_true = gate(true_ct, true_ct)
    if scheme != "3gen":  # NAND(1, 1) = 0: negated, a bootstrapped True
        out_true = -out_true
    classes = _next_gate_classes(out, out_true, lambda x: mk_lwe_phase(x, keys), want, wrong,
                                 ck.params.rlwe_polynomial_degree)
    return _report(fresh, boot, wrong, *_multikey_bytes(ck, scheme), wall, classes, pre)


def _pre_keyswitch_noise(secret_keys, ck, ct, true_ct, want: torch.Tensor) -> np.ndarray:
    """The AND's extracted sample before the per-party keyswitch, its noise
    under the sum of the parties' extracted ring keys (the implicit key of
    the AKÖ accumulator: the keyswitch applies each party's table to the
    same mask)."""
    from ..boot.gates import EIGHTH
    from ..mk import boot3gen, gates3gen
    from ..mk.samples import mk_lwe_noiseless_trivial
    from ..rlwe import extract_lwe_key

    params = ck.params
    temp = mk_lwe_noiseless_trivial(EIGHTH[-1], params.lwe, ck.parties, ct.b.shape,
                                    device=ct.b.device) + ct + true_ct
    u = boot3gen.mk_bootstrap_wo_keyswitch(ck, gates3gen.MU, temp)
    bits = 8 * u.b.element_size()
    key_sum = sum(_host(extract_lwe_key(s.rlwe).key).astype(np.int64) for s in secret_keys)
    ua, ub = _host(u.a).astype(np.int64), _host(u.b).astype(np.int64)
    with np.errstate(over="ignore"):
        phase = ub - ua @ key_sum  # int64 wraps: exact at 64 bits
    if bits == 32:
        phase = phase % (1 << 32)
        phase = np.where(phase >= (1 << 31), phase - (1 << 32), phase)
    dtype = torch.int32 if bits == 32 else torch.int64
    return _host(noise_calc(_pm_eighth(want.cpu(), dtype),
                            torch.from_numpy(phase.astype(np.int32 if bits == 32 else np.int64))))
