"""tools/perf_comp.py (the port's counterpart of benchmarks/perf_comp.py)
and the CCS noise prediction its rows are gated by, on the CPU.

- ``params_for`` gives the JAX registry's sets field for field, under
  ``--real`` and under ``--fixed-set 16``;
- at the test sets (2 and 3 parties), JAX makes the keys and they cross
  through ``bridge.py``: every ciphertext pair a row NANDs gives JAX's
  ``mk_gate_nand`` words on the same keys (tolerance 0), and the row reports
  ``correct`` and its noise gate met;
- ``main()`` on the CPU, its CCS and KMS keys made in keygen workers as on
  the card, prints one row a scheme with the key's bytes equal to those
  from shapes and returns 0, and returns 1 when a gate decrypts wrong; a
  worker's key (fb and conv forms) is the key made in this process from
  the same seed, and a cache file is whole or absent;
- ``scheme_noise.ccs_noise_std`` on a key of a 12-digit base-4 gadget (the
  16-party set's) predicts the measured std within the gate's band, where
  the digits' mean makes the std several times the old prediction; its
  coherent part on a key equals a direct sum over the runs of steps,
  written here in plain numpy.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_kms_gadget_helpers import _one_torch_thread  # noqa: F401

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import ccs as jccs
from torus_fhe_tpu.mk import gates3gen as jgates3
from torus_fhe_tpu.mk import kms as jkms
from torus_fhe_tpu.mk.samples import MKLweSample as JSample
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import ccs, kms
from torus_fhe_tpu_torch.tools import perf_comp, scheme_noise

B = 64  # gates a row: enough for a std to within ~10%


@pytest.mark.parametrize("scheme", perf_comp.SCHEMES)
def test_params_for_equals_the_jax_registry(scheme):
    for parties in (2, 4, 8, 16):
        got = perf_comp.params_for(scheme, parties, real=True)
        want = jparams.PARAMETER_REGISTRY[f"mk_{parties}party_{scheme}"]()
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for parties in (2, 4, 8):  # the reference protocol: the 16-party set at fewer parties
        got = perf_comp.params_for(scheme, parties, fixed_set=16)
        want = dataclasses.replace(jparams.PARAMETER_REGISTRY[f"mk_16party_{scheme}"](),
                                   max_parties=parties)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    test = perf_comp.params_for(scheme, 3, n=8, N=64)
    assert (test.max_parties, test.lwe_size, test.rlwe_polynomial_degree) == (3, 8, 64)


def jax_keys(scheme: str, parties: int):
    """JAX's keys at the scheme's test set and the port's view of them."""
    make = {"3gen": jparams.test_parameters_3gen, "ccs": jparams.test_parameters_ccs,
            "kms": jparams.test_parameters_kms}[scheme]
    params = make(parties=parties, n=16, N=64)
    tp = getattr(tparams, type(params).__name__)(**dataclasses.asdict(params))
    keygen = {"3gen": jmk.mk_party_keygen, "ccs": jccs.ccs_party_keygen,
              "kms": jkms.kms_party_keygen}[scheme]
    sks = [keygen(jax.random.PRNGKey(90 + p), params) for p in range(parties)]
    tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(s.lwe.key) for s in sks],
                                            [np.asarray(s.rlwe.key) for s in sks], device="cpu")
    if scheme == "3gen":
        ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(9), sks, params, forms=("fblock",),
                                 keep_samples=True)
        tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat),
                                             parties, forms=("fblock",), device="cpu")
    else:
        cloud = jccs.ccs_cloud_keygen if scheme == "ccs" else jkms.kms_cloud_keygen
        ck = cloud(jax.random.PRNGKey(9), sks, params, forms=("fb",))
        fields = {f.name: np.asarray(getattr(ck, f.name)) for f in dataclasses.fields(ck)
                  if f.name not in ("parties", "params") and getattr(ck, f.name) is not None}
        to_port = getattr(bridge, f"{scheme}_cloud_key_from_numpy")
        tck = to_port(tp, parties, device="cpu", **fields)
    return ck, tck, tsks


@pytest.mark.parametrize("parties", [2, 3])
@pytest.mark.parametrize("scheme", perf_comp.SCHEMES)
def test_row_words_equal_jax(scheme, parties, monkeypatch):
    ck, tck, tsks = jax_keys(scheme, parties)
    calls = []
    gate = perf_comp.GATES[scheme]

    def kept(k, x, y):
        out = gate(k, x, y)
        calls.append((x, y, out))
        return out

    monkeypatch.setitem(perf_comp.GATES, scheme, kept)
    rec = perf_comp.row(scheme, tck, tsks, B, 1, seed=parties)
    assert rec["correct"] and rec["noise_ok"], (rec["fails"], rec["gate"])
    assert rec["wrong"] == 0 and rec["trials"] == 1 and len(calls) == 2  # warm-up and one trial
    assert rec["steps"] == parties * 16 and rec["bound_ms"] > 0
    jgate = {"3gen": jgates3.mk_gate_nand, "ccs": jccs.mk_gate_nand,
             "kms": jkms.mk_gate_nand}[scheme]
    x, y, out = calls[0]
    jx, jy = (JSample(jnp.asarray(c.a.numpy()), jnp.asarray(c.b.numpy())) for c in (x, y))
    backend = jboot.get_rotate_backend()
    jboot.set_rotate_backend("fblock")  # JAX's plain F-block scan: the same words as Pallas
    try:
        want = jgate(ck, jx, jy)
    finally:
        jboot.set_rotate_backend(backend)
    np.testing.assert_array_equal(out.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(out.b.numpy(), np.asarray(want.b))
    for _, _, again in calls[1:]:
        assert torch.equal(again.a, out.a) and torch.equal(again.b, out.b)


def run_main(capsys, *argv) -> tuple:
    """(exit code, the rows) of perf_comp.main on the CPU."""
    rc = perf_comp.main(["--device", "cpu", "--batch", "16", "--trials", "1", *argv])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"  # the card's line: here the CPU
    return rc, [json.loads(line) for line in lines[1:]]


def test_main_prints_a_checked_row_a_scheme(capsys):
    rc, rows = run_main(capsys, "--parties", "2", "--n", "8")
    assert rc == 0
    assert [r["scheme"] for r in rows] == ["3gen-fb", "ccs-fb", "kms-fb"]
    for r in rows:
        assert r["correct"] and r["noise_ok"] and r["wrong"] == 0
        assert r["key_bytes"] == r["key_bytes_from_shapes"] > 0
        assert ("waited_s" in r["keygen"]) == (r["scheme"] != "3gen-fb")  # a worker's key
        assert r["parties"] == 2 and r["batch"] == 16 and r["size"] == "n=8 N=64"
        assert r["min_s"] <= r["median_s"] and r["gates_per_s"] == 16 / r["min_s"]


def test_main_fails_on_a_wrong_row(capsys, monkeypatch):
    def wrong(k, x, y):  # the gate's output with its body moved half a torus: every bit flips
        out = kms.mk_gate_nand(k, x, y)
        return mk.MKLweSample(out.a, out.b + (1 << 31) - 2**32)

    monkeypatch.setitem(perf_comp.GATES, "kms", wrong)
    rc, rows = run_main(capsys, "--parties", "2", "3", "--n", "8", "--schemes", "kms")
    assert rc == 1
    assert len(rows) == 1 and not rows[0]["correct"] and rows[0]["wrong"] == 16


@pytest.mark.parametrize("parties", [2, 3])
def test_ccs_noise_prediction_with_the_digit_mean(parties):
    """At the 16-party set's gadget (l = 12, Bg = 2^2: digits of mean
    -1/2 against a variance of 5/4) the phase error's mean part dominates:
    the measured std is several times the old prediction and within the
    band of the prediction on the key."""
    params = dataclasses.replace(tparams.test_parameters_ccs(parties, 24, 256),
                                 bs_decomp_length=12, bs_log2_base=2, bs_noise_stddev=1e-7,
                                 ks_noise_stddev=0.0)
    gen = torch.Generator().manual_seed(parties)
    sks = [ccs.ccs_party_keygen(gen, params, device="cpu") for _ in range(parties)]
    ck = ccs.ccs_cloud_keygen(gen, sks, params, device="cpu")
    rec = perf_comp.row("ccs", ck, sks, 256, 1, seed=7, warmup=False)
    old = math.sqrt(parties * 24 * parties * 128 * 12 * 256 * (16 + 2) / 12 * 1e-14)
    assert rec["boot_noise_std"] > 2.5 * old
    lo, hi = perf_comp.CCS_NOISE_BAND
    assert lo <= rec["std_over_prediction"] <= hi
    assert rec["predicted_std"] == scheme_noise.ccs_noise_std(params, ck, sks)


def test_keygen_only_keeps_keys_a_later_run_loads(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(perf_comp, "CACHE_DIR", str(tmp_path))
    rc, rows = run_main(capsys, "--parties", "2", "--n", "8", "--keygen-only")
    assert rc == 0 and rows == []  # the CCS and KMS files written by their workers
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"perf_{s}-fb_p2_n8N64{tail}.npz" for s in perf_comp.SCHEMES for tail in ("", "_secrets"))
    rc, rows = run_main(capsys, "--parties", "2", "--n", "8")
    assert rc == 0 and len(rows) == 3
    for r in rows:
        assert r["keygen"]["cached"].startswith(str(tmp_path))
        assert r["correct"] and r["noise_ok"] and r["key_bytes"] == r["key_bytes_from_shapes"]


def test_no_fblock_takes_the_conv_forms(capsys):
    rc, rows = run_main(capsys, "--parties", "2", "--n", "8", "--no-fblock")
    assert rc == 0
    assert [r["scheme"] for r in rows] == ["3gen", "ccs", "kms"]
    assert all(r["correct"] and r["noise_ok"] and r["wrong"] == 0 for r in rows)
    assert rows[0]["key_bytes"] == rows[0]["key_bytes_from_shapes"]  # the exact 3gen lines
    assert all("waited_s" in r["keygen"] for r in rows[1:])


def key_tensors(ck) -> dict:
    return {k: v for k, v in vars(ck).items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("scheme", ["ccs", "kms"])
def test_worker_key_equals_the_key_made_here(scheme):
    """start_keygens / take_key in the fb and the conv form, two workers at
    once: the fields handed over rebuild the key that scheme_keys makes in
    this process from the same seed."""
    params = perf_comp.params_for(scheme, 2, n=8)
    forms = {"fb": ("fb",), "conv": ("conv",)}
    try:
        perf_comp.start_keygens([(f"{scheme}_{f}", params, 5, fs, None)
                                 for f, fs in forms.items()], prefix="test_perf_comp_")
        got = {f: perf_comp.take_key(f"{scheme}_{f}", params, "cpu", 300.0, fs)
               for f, fs in forms.items()}
    finally:
        perf_comp.stop_keygens()
    for f, fs in forms.items():
        ck, sks, made, _, _ = got[f]
        want, want_sks = perf_comp.scheme_keys(scheme, params, 5, "cpu", fs)
        assert made["keygen_s"] > 0 and made["npy_bytes"] > 0
        have = key_tensors(ck)
        assert have.keys() == key_tensors(want).keys()
        for k, v in key_tensors(want).items():
            assert torch.equal(have[k], v), (f, k)
        for sk, wsk in zip(sks, want_sks, strict=True):
            assert torch.equal(sk.lwe.key, wsk.lwe.key)
            assert torch.equal(sk.rlwe.key, wsk.rlwe.key)


def test_a_cache_file_is_whole_or_absent(tmp_path, monkeypatch):
    """save_cache stopped between its two files leaves nothing at the
    cloud key's path; a whole save loads back the same key."""
    params = perf_comp.params_for("ccs", 2, n=8)
    ck, sks = perf_comp.scheme_keys("ccs", params, 3, "cpu", ("fb",))
    path = str(tmp_path / "perf_ccs-fb_p2_n8N64.npz")

    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")

    with monkeypatch.context() as m:
        m.setattr(perf_comp.serialize, "save_named", full_disk)
        with pytest.raises(OSError):
            perf_comp.save_cache(path, "ccs", ck, sks)
    assert not os.path.exists(path)
    perf_comp.save_cache(path, "ccs", ck, sks)
    assert sorted(os.listdir(tmp_path)) == ["perf_ccs-fb_p2_n8N64.npz",
                                            "perf_ccs-fb_p2_n8N64_secrets.npz"]
    got, got_sks = perf_comp.load_cache(path, "ccs", ("fb",), "cpu")
    for k, v in key_tensors(ck).items():
        assert torch.equal(key_tensors(got)[k], v), k
    assert all(torch.equal(a.lwe.key, b.lwe.key) for a, b in zip(got_sks, sks, strict=True))


def negacyclic(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (*) b in Z[X]/(X^N + 1), schoolbook: X^i b is b shifted by i with
    the wrapped coefficients negated."""
    N = len(a)
    out = np.zeros(N, dtype=np.result_type(a, b))
    for i in range(N):
        out += a[i] * np.concatenate([-b[N - i:], b[:N - i]])
    return out


def test_coherent_part_equals_a_direct_sum(monkeypatch):
    """scheme_noise._coherent_var on a 3-party key against the sum written
    out: e_j = b_j - s_j (*) a from the public keys as keygen made them,
    F_j = (1 (*) 1) (*) (e_j summed over levels), and over the runs of
    steps (a new run at each key bit 1) the squared norm of the sum of the
    F of each step's active masks (j below the step's party, and its own
    after the party's first step), over 16 N."""
    made = []
    public_keygen = ccs.ccs_public_keygen

    def kept(generator, rlwe_key, shared_a, params):
        b = public_keygen(generator, rlwe_key, shared_a, params)
        made.append((rlwe_key.key[0].numpy().astype(np.int64), np.asarray(shared_a), b))
        return b

    monkeypatch.setattr(ccs, "ccs_public_keygen", kept)
    parties, n, N = 3, 8, 64
    params = dataclasses.replace(tparams.test_parameters_ccs(parties, n, N), bs_decomp_length=3,
                                 bs_log2_base=4, bs_noise_stddev=1e-4)
    ck, sks = perf_comp.scheme_keys("ccs", params, 11, "cpu", ("fb",))
    ones = np.ones(N)
    F = []
    for s, a, b in made:
        e = np.zeros(N)
        for level in range(params.bs_decomp_length):
            word = (b[level].astype(np.int64) - negacyclic(s, a[level].astype(np.int64) % 2**32)
                    ) % 2**32
            e += np.where(word >= 2**31, word - 2**32, word) / 2**32
        F.append(negacyclic(negacyclic(ones, ones), e))
    bits = np.concatenate([sk.lwe.key.numpy() for sk in sks])
    assert 0 < bits.sum() < len(bits)
    runs, cur = [], np.zeros(N)
    for step, bit in enumerate(bits):
        if bit:  # the rotation of this step's CMux: a new run
            runs.append(cur)
            cur = np.zeros(N)
        owner, t = divmod(step, n)
        for j in range(parties):
            if j < owner or (j == owner and t > 0):
                cur = cur + F[j]
    runs.append(cur)
    want = sum(float((r**2).sum()) for r in runs) / (16 * N)
    assert want > 0
    assert scheme_noise._coherent_var(ck, sks) == pytest.approx(want, rel=1e-9)


def test_measure_on_keys_made_elsewhere():
    params = perf_comp.params_for("ccs", 2, n=8)
    ck, sks = perf_comp.scheme_keys("ccs", params, 4, "cpu", ("fb",))
    rec = scheme_noise.measure(ck, sks, seed=2, batch=32)
    assert rec["wrong"] == 0 and rec["batch"] == 32 and rec["std"] > 0
    assert rec["std_over_key_prediction"] == rec["std"] / scheme_noise.ccs_noise_std(params, ck,
                                                                                       sks)
