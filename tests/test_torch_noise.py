"""The port's noise harness (utils/noise.py) and ``core.torus.noise_calc``
against the JAX package's.

Parity: the keys, messages and ciphertexts that JAX's ``measure_single_key``
and ``measure_multikey`` draw are rebuilt here from the same PRNG keys, as
its harness draws them, and cross to the port through ``bridge.py``; the
port's report step runs on them. Gate words are equal, so the counts, the
indices and the classes of the two reports are equal and the noise floats
come from equal words. The port's own keys (torch's RNG) are held to the
JAX test's bounds: 0 wrong and every bootstrapped noise under 1/8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.core.torus import noise_calc as j_noise_calc
from torus_fhe_tpu.mk import ccs as jccs
from torus_fhe_tpu.mk import kms as jkms
from torus_fhe_tpu.utils import noise as jnoise
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core.torus import noise_calc
from torus_fhe_tpu_torch.utils import noise

FLOATS = ("fresh_noise_std", "fresh_noise_max", "boot_noise_std", "boot_noise_max",
          "pre_ks_noise_std", "pre_ks_noise_max")
EQUAL = ("trials", "wrong_decryptions", "wrong_indices", "wrong_phase_gt_quarter",
         "wrong_phase_lt_zero", "wrong_classes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_params(params):
    return getattr(tparams, type(params).__name__)(**dataclasses.asdict(params))


def _same_report(got, want):
    """Counts, indices and classes equal; the noise floats within 1e-6 and
    the per-trial noises equal; wall time and key bytes left out."""
    for f in EQUAL:
        assert getattr(got, f) == getattr(want, f), f
    for f in FLOATS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert abs(g - w) <= 1e-6, (f, g, w)
    np.testing.assert_array_equal(got.boot_noises, want.boot_noises)
    np.testing.assert_array_equal(got.fresh_noises, want.fresh_noises)


@pytest.mark.parametrize("bits", [32, 64])
def test_noise_calc_equals_jax(bits):
    """Equal floats, bit for bit, on seeded pairs and at the wrap points."""
    rng = np.random.default_rng(bits)
    dt = np.int32 if bits == 32 else np.int64
    lo, hi = -2**(bits - 1), 2**(bits - 1) - 1
    m = rng.integers(lo, hi, 20_000, dtype=np.int64).astype(dt)
    d = rng.integers(lo, hi, 20_000, dtype=np.int64).astype(dt)
    edge = np.array([lo, hi, 0, 1, -1, 2**(bits - 2), -2**(bits - 2), 2**(bits - 2) + 1,
                     -2**(bits - 2) - 1], dtype=dt)
    m = np.concatenate([m, np.repeat(edge, edge.size), m[:500]])
    d = np.concatenate([d, np.tile(edge, edge.size), m[:500] + dt(3)])
    got = noise_calc(torch.from_numpy(m), torch.from_numpy(d)).numpy()
    want = np.asarray(j_noise_calc(jnp.asarray(m), jnp.asarray(d)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.all(np.abs(got) <= 0.5)  # float32 rounding may land on -0.5, as in JAX


def test_rounded_phase_classes_equal_jax():
    """JAX's own case, then seeded phases with wrong subsets."""
    cases = [(np.array([0.3, -0.05, 0.1, 0.26]), [1, 2])]
    rng = np.random.default_rng(7)
    for n in (64, 1024):
        ph = rng.uniform(-0.5, 0.5, n)
        cases.append((ph, sorted(rng.choice(n, 9, replace=False).tolist())))
        cases.append((np.concatenate([ph, [0.25, 0.0, -0.0]]), [n, n + 1, n + 2]))
    for ph, wrong in cases:
        assert noise._rounded_phase_classes(ph, wrong) == jnoise._rounded_phase_classes(ph, wrong)


@pytest.mark.parametrize("N", [64, 1024])
@pytest.mark.parametrize("bits", [32, 64])
def test_round_mod_switch_equals_jax(N, bits):
    rng = np.random.default_rng(N + bits)
    dt = np.int32 if bits == 32 else np.int64
    a = rng.integers(-2**(bits - 1), 2**(bits - 1), (8, 5), dtype=np.int64).astype(dt)
    b = rng.integers(-2**(bits - 1), 2**(bits - 1), 8, dtype=np.int64).astype(dt)
    a[0, :3] = [-2**(bits - 1), 2**(bits - 1) - 1, 0]
    ra, rb = noise._round_mod_switch(torch.from_numpy(a), torch.from_numpy(b), N)
    ja, jb = jnoise._round_mod_switch(jnp.asarray(a), jnp.asarray(b), N)
    np.testing.assert_array_equal(ra.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(rb.numpy(), np.asarray(jb))
    assert ra.dtype == torch.from_numpy(a).dtype
    step = 1 << (bits - (2 * N).bit_length() + 1)  # 2^bits / 2N
    assert np.all(ra.numpy() % step == 0)


def test_single_key_report_equals_jax():
    """JAX's measure_single_key(PRNGKey(0), test_parameters(16, 64), 64) and
    the port's report step on the keys and ciphertexts it draws."""
    key = jax.random.PRNGKey(0)
    params = jparams.test_parameters(n=16, N=64)
    want = jnoise.measure_single_key(key, params, trials=64)
    k1, k2, k3 = jax.random.split(key, 3)
    sk, ck = japi.make_key_pair(k1, params, forms=("conv",))
    msgs = jax.random.bernoulli(k2, 0.5, (64,))
    ct = japi.encrypt(k3, sk, msgs)
    true_ct = japi.encrypt(jax.random.fold_in(key, 9), sk, jnp.ones((64,), bool))
    tp = _port_params(params)
    bk, ks = ck.bootstrap_key, ck.keyswitch_key
    tsk = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
    tck = bridge.cloud_key_from_numpy(tp, np.asarray(bk.samples), np.asarray(ks.mat), ks.n_in,
                                      ks.n_out, device="cpu")
    got = noise.report_single_key(tsk, tck, torch.from_numpy(np.array(msgs)),
                                  *(bridge.lwe_from_numpy(np.asarray(c.a), np.asarray(c.b),
                                                          device="cpu") for c in (ct, true_ct)))
    _same_report(got, want)
    assert got.bk_bytes == tck.bootstrap_key.fb.nbytes > 0 and got.ks_bytes > 0


def _jax_multikey_inputs(key, params, parties, trials, scheme, forms=None):
    """The keys and ciphertexts JAX's measure_multikey draws from ``key``,
    and the port's view of them."""
    if scheme == "3gen":
        sks = [jmk.mk_party_keygen(jax.random.fold_in(key, 100 + p), params)
               for p in range(parties)]
        ck = jmk.mk_cloud_keygen(jax.random.fold_in(key, 7), sks, params, forms=forms,
                                 keep_samples=True)
    else:
        party = jccs.ccs_party_keygen if scheme == "ccs" else jkms.kms_party_keygen
        cloud = jccs.ccs_cloud_keygen if scheme == "ccs" else jkms.kms_cloud_keygen
        sks = [party(jax.random.fold_in(key, 100 + p), params) for p in range(parties)]
        ck = cloud(jax.random.fold_in(key, 7), sks, params)
    keys = [sk.lwe for sk in sks]
    msgs = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (trials,))
    ct = jmk.mk_encrypt(jax.random.fold_in(key, 2), keys, msgs, params)
    true_ct = jmk.mk_encrypt(jax.random.fold_in(key, 3), keys, jnp.ones((trials,), bool), params)
    tp = _port_params(params)
    tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(s.lwe.key) for s in sks],
                                            [np.asarray(s.rlwe.key) for s in sks], device="cpu")
    if scheme == "3gen":
        tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat),
                                             parties, forms=forms, device="cpu")
    else:
        fields = {f.name: np.asarray(getattr(ck, f.name)) for f in dataclasses.fields(ck)
                  if f.name not in ("parties", "params") and getattr(ck, f.name) is not None}
        make = bridge.ccs_cloud_key_from_numpy if scheme == "ccs" else \
            bridge.kms_cloud_key_from_numpy
        tck = make(tp, parties, device="cpu", **fields)
    tcts = [bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
            for c in (ct, true_ct)]
    return tsks, tck, torch.from_numpy(np.array(msgs)), tcts


@pytest.mark.parametrize("fast_form", [None, False], ids=["fblock", "exact"])
def test_3gen_report_equals_jax(fast_form):
    """measure_multikey at test_parameters_3gen(2, 16, 64), 32 trials: the
    fblock form (the hi-word chain) and fast_form=False (JAX's conv scan,
    the port's exact route), pre-keyswitch fields included."""
    key = jax.random.PRNGKey(1)
    params = jparams.test_parameters_3gen(parties=2, n=16, N=64)
    want = jnoise.measure_multikey(key, params, parties=2, trials=32, fast_form=fast_form)
    forms = ("fblock",) if fast_form is None else ("conv",)
    tsks, tck, msgs, (ct, true_ct) = _jax_multikey_inputs(key, params, 2, 32, "3gen", forms)
    assert tck.exact == (fast_form is False)
    got = noise.report_multikey(tsks, tck, msgs, ct, true_ct, "3gen")
    assert want.pre_ks_noise_std is not None
    _same_report(got, want)


@pytest.mark.parametrize("scheme", ["ccs", "kms"])
def test_ccs_kms_report_equals_jax(scheme):
    """measure_multikey at test_parameters_{ccs,kms}(2, 16, 64), 16 trials,
    with JAX's default (conv-form) keys crossing by field name."""
    key = jax.random.PRNGKey(2 if scheme == "ccs" else 3)
    make = jparams.test_parameters_ccs if scheme == "ccs" else jparams.test_parameters_kms
    params = make(parties=2, n=16, N=64)
    want = jnoise.measure_multikey(key, params, parties=2, trials=16, scheme=scheme)
    tsks, tck, msgs, (ct, true_ct) = _jax_multikey_inputs(key, params, 2, 16, scheme)
    got = noise.report_multikey(tsks, tck, msgs, ct, true_ct, scheme)
    assert got.pre_ks_noise_std is None
    _same_report(got, want)


@pytest.mark.parametrize("case", ["single", "3gen", "3gen_exact", "ccs", "kms"])
def test_port_keys_report_clean(case):
    """The public entries with the port's own keys on the CPU: 0 wrong and
    every bootstrapped noise under 1/8 (JAX's bounds)."""
    g = torch.Generator().manual_seed(11)
    if case == "single":
        rep = noise.measure_single_key(g, tparams.test_parameters(n=16, N=64), trials=64,
                                       device="cpu")
        assert rep.bk_bytes > 0 and rep.ks_bytes > 0
    elif case.startswith("3gen"):
        rep = noise.measure_multikey(g, tparams.test_parameters_3gen(parties=2, n=16, N=64), 2,
                                     trials=32, fast_form=False if case == "3gen_exact" else None,
                                     device="cpu")
        assert rep.pre_ks_noise_std is not None and rep.pre_ks_noise_max < 0.125
    else:
        make = tparams.test_parameters_ccs if case == "ccs" else tparams.test_parameters_kms
        rep = noise.measure_multikey(g, make(parties=2, n=16, N=64), 2, trials=16, scheme=case,
                                     device="cpu")
    assert rep.wrong_decryptions == 0, rep.to_json()
    assert rep.boot_noise_max < 0.125, rep.to_json()
    assert rep.boot_noises.shape == rep.fresh_noises.shape == (rep.trials,)


def test_cache_path_round_trip(tmp_path):
    """keygen_only writes the cloud key; a run at the same seed that loads it
    reports what a run without a cache reports."""
    params = tparams.test_parameters_3gen(parties=2, n=16, N=64)
    path = str(tmp_path / "mk.key")
    run = lambda **kw: noise.measure_multikey(torch.Generator().manual_seed(5), params, 2,
                                              trials=16, device="cpu", **kw)
    assert run(cache_path=path, keygen_only=True) is None
    loaded, fresh = run(cache_path=path), run()
    _same_report(loaded, fresh)
    assert (loaded.bk_bytes, loaded.ks_bytes) == (fresh.bk_bytes, fresh.ks_bytes)
    assert loaded.wrong_decryptions == 0
    with pytest.raises(ValueError, match="scheme"):
        noise.measure_multikey(torch.Generator(), params, 2, scheme="scheme", device="cpu")


def test_artifacts_equal_jax(tmp_path):
    """Equal reports write equal files: the .dat rows and the log lines."""
    rng = np.random.default_rng(3)
    boot = rng.normal(0, 0.01, 20).astype(np.float32)
    fields = dict(trials=20, fresh_noise_std=1.5e-5, fresh_noise_max=4e-5,
                  boot_noise_std=float(boot.std()), boot_noise_max=float(np.abs(boot).max()),
                  wrong_decryptions=2, wrong_indices=[3, 17], bk_bytes=123, ks_bytes=45,
                  bootstrap_wall_s=0.5, wrong_phase_gt_quarter=1, wrong_phase_lt_zero=1,
                  boot_noises=boot, fresh_noises=boot / 100, pre_ks_noise_std=0.002,
                  pre_ks_noise_max=0.006,
                  wrong_classes=["rounded_phase_lt_zero", "boot_noise"])
    got, want = noise.NoiseReport(**fields), jnoise.NoiseReport(**fields)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert got.to_json() == want.to_json()
    got.write_artifacts(str(tmp_path / "port"), "tag")
    want.write_artifacts(str(tmp_path / "jax"), "tag")
    for name in ("noises__tag.dat", "log__tag.log"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
