"""The port's LWE -> RLWE packing (boot/pack.py) and its contraction
(ops/poly.pack_kernels_host, negacyclic_extern_product) against the JAX
package.

Word for word (max |diff| 0): the packed limbs, the contraction on random
digits and kernels (32 and 64 bits) against JAX's backends, and ``pack_lwes`` on a JAX packing key crossed through
``bridge.packing_key_from_numpy`` at ``test_parameters(n=16, N=64)``. A
geometry whose int32 sums wrap (n = 700, l = 3, N = 64: 134,400 products a
sum, every digit and limb -128) is held against an int64 plain version of
the packing and against JAX. The port's own packing keys (torch RNG) are
checked by decryption and by the packing noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import pack as jpack
from torus_fhe_tpu.core.params import test_parameters as make_test_params
from torus_fhe_tpu.lwe import LweSample as JLweSample
from torus_fhe_tpu.ops import poly as jpoly
from torus_fhe_tpu.rlwe import rlwe_keygen as j_rlwe_keygen
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.boot import api, pack
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core.torus import encode_message
from torus_fhe_tpu_torch.lwe import LweKey, LweSample
from torus_fhe_tpu_torch.ops import poly
from torus_fhe_tpu_torch.rlwe import RLweKey, RLweSample, rlwe_keygen, rlwe_phase

PARAMS = make_test_params(n=16, N=64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that the workers of a parallel test run do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_product(digits, packed, bits, C, backend):
    jpoly.set_backend(backend)
    try:
        return np.asarray(jpoly.negacyclic_extern_product(jnp.asarray(digits), jnp.asarray(packed),
                                                          bits, C))
    finally:
        jpoly.set_backend("conv")


@pytest.mark.parametrize("B,R,N,C,bits", [(3, 7, 64, 2, 32), (1, 5, 32, 3, 32),
                                          (2, 4, 16, 2, 64), (33, 3, 64, 3, 32)])
def test_extern_product_equal_jax(B, R, N, C, bits):
    rng = np.random.default_rng(B * R)
    digits = rng.integers(-128, 128, (B, R, N)).astype(np.int8)
    kern = rng.integers(-2**(bits - 1), 2**(bits - 1), (R, C, N), dtype=np.int64)
    kern = kern.astype(np.int32 if bits == 32 else np.int64)
    packed = poly.pack_kernels_host(kern, bits)
    np.testing.assert_array_equal(packed, jpoly.pack_kernels_host(kern, bits))
    got = poly.negacyclic_extern_product(torch.from_numpy(digits), torch.from_numpy(packed),
                                         bits, C)
    assert got.dtype == (torch.int32 if bits == 32 else torch.int64) and got.shape == (B, C, N)
    for backend in ("conv", "matmul"):
        np.testing.assert_array_equal(got.numpy(), _jax_product(digits, packed, bits, C, backend))


def _check_all_minus_128(bits):
    """Every digit and limb -128 at R * N = 134,400: against the int64 plain
    version (its sums wrap mod 2^64), reduced to the torus once at the end."""
    B, R, N, C = 1, 2100, 64, 2
    L = poly.n_limbs_for(bits)
    dtype = torch.int32 if bits == 32 else torch.int64
    digits = torch.full((B, R, N), -128, dtype=torch.int8)
    packed = torch.full((C * L, R, N), -128, dtype=torch.int8)
    limb_sum = R * N * 128 * 128
    assert limb_sum > 2**31 - 1 and poly.INT32_TERMS * 128 * 128 <= 2**31 - 1
    calls = poly.int8_matmul.calls
    got = poly.negacyclic_extern_product(digits, packed, bits, C)
    assert poly.int8_matmul.calls - calls == -(-R // (poly.INT32_TERMS // N))
    kern = poly.limb_combine(packed.flip(-1).reshape(C, L, R, N).to(torch.int32), bits, dim=1)
    want = torch.zeros((B, C, N), dtype=torch.int64)
    for c in range(C):
        want[:, c] = poly.negacyclic_polymul_ref(digits[0].to(torch.int64),
                                                 kern[c].to(torch.int64)).sum(0)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want.to(dtype).numpy())


def test_extern_product_chunks_bound_the_int32_sums():
    """Each limb sum of 134,400 products of -128 reaches 2^31 * 1.025, past
    int32. The port splits the reduction into chunks of at most INT32_TERMS
    products and equals the int64 plain version."""
    _check_all_minus_128(32)


def test_extern_product_keeps_the_64_bit_carries():
    """At 64 bits the chunk sums add in int64, so their carries past 2^32
    reach the higher limbs' scale and the product is exact mod 2^64. (JAX's
    product adds its limb sums in int32 and loses them: ROADMAP.md, faults
    of the reference.)"""
    _check_all_minus_128(64)


@pytest.fixture(scope="module")
def jax_world():
    sk, _ = japi.make_key_pair(jax.random.PRNGKey(0), PARAMS, forms=("fblock",))
    rk = j_rlwe_keygen(jax.random.PRNGKey(1), PARAMS.rlwe)
    pk = jpack.packing_keyswitch_keygen(jax.random.PRNGKey(2), 2**-20, sk.key, rk, PARAMS.rlwe)
    tpk = bridge.packing_key_from_numpy(np.asarray(pk.kernels), pk.n_in, pk.decomp_length,
                                        pk.log2_base, pk.bits, pk.mask_size, device="cpu")
    return sk, rk, pk, tpk


@pytest.mark.parametrize("shape", [(32,), (3, 8), (2, 2, 64)])
def test_pack_lwes_equal_jax(jax_world, shape):
    sk, rk, pk, tpk = jax_world
    bits = np.random.default_rng(len(shape)).integers(0, 2, shape) == 1
    ct = japi.encrypt(jax.random.PRNGKey(3), sk, jnp.asarray(bits))
    want = jpack.pack_lwes(pk, ct, PARAMS.rlwe.polynomial_degree)
    got = pack.pack_lwes(tpk, bridge.lwe_from_numpy(np.asarray(ct.a), np.asarray(ct.b),
                                                    device="cpu"),
                         PARAMS.rlwe.polynomial_degree)
    assert got.a.shape == shape[:-1] + (2, 64)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    phase = rlwe_phase(got, RLweKey(torch.from_numpy(np.array(rk.key)), 32))
    np.testing.assert_array_equal((phase[..., :shape[-1]] > 0).numpy(), bits)


def test_pack_lwes_wrapping_geometry_equal_int64_and_jax():
    """n = 700, l = 3 at N = 64: R = 2,100 digit rows. A crafted key whose
    limbs are all -128 and masks a = -offset (every digit -128) drive each
    limb sum to 2^31 * 1.025; the port equals an int64 plain version of
    the packing and JAX's packing of the same inputs."""
    n, l, N, m = 700, 3, 64, 64
    tg = tparams.TGswParams(l, 8, 32)
    packed = np.full((2 * 4, n * l, N), -128, np.int8)
    tpk = bridge.packing_key_from_numpy(packed, n, l, 8, 32, 1, device="cpu")
    jpk = jpack.PackingKey(jnp.asarray(packed), n, l, 8, 32, 1)
    a = np.full((m, n), -tg.offset, np.int64).astype(np.int32)
    a[:, ::7] = np.random.default_rng(0).integers(-2**31, 2**31, (m, n))[:, ::7]
    b = np.arange(m, dtype=np.int32) << 20
    got = pack.pack_lwes(tpk, bridge.lwe_from_numpy(a, b, device="cpu"), N)

    # int64 plain version: decompose, then sum_{j,r} g_r(A_j) (*) KSK_{j,r}
    A = torch.nn.functional.pad(torch.from_numpy(a).T, (0, N - m))  # (n, N)
    digits = poly.decompose(A, l, 8, 32, tg.offset).reshape(n * l, N).to(torch.int64)
    assert (digits == -128).float().mean() > 0.8
    kern = poly.limb_combine(torch.from_numpy(packed).flip(-1).reshape(2, 4, n * l, N)
                             .to(torch.int32), 32, dim=1).to(torch.int64)
    delta = torch.stack([poly.negacyclic_polymul_ref(digits, kern[c]).sum(0) for c in range(2)])
    want = -delta
    want[-1, :m] += torch.from_numpy(b).to(torch.int64)
    np.testing.assert_array_equal(got.a.numpy(), want.to(torch.int32).numpy())
    jgot = jpack.pack_lwes(jpk, JLweSample(jnp.asarray(a), jnp.asarray(b)), N)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(jgot.a))


def test_port_packing_key_decrypts():
    """The port's own keys: 32 bits packed into one RLWE sample decrypt, the
    packing noise under 1/16; a batch of 3 x 8 packs into 3 samples."""
    params = tparams.test_parameters(n=16, N=64)
    g = torch.Generator().manual_seed(0)
    sk, _ = api.make_key_pair(g, params, device="cpu")
    rk = rlwe_keygen(g, params.rlwe)
    pk = pack.packing_keyswitch_keygen(g, 2**-20, sk.key, rk, params.rlwe, device="cpu")
    assert pk.kernels.shape == (2 * 4, 16 * 3, 64) and pk.kernels.dtype == torch.int8
    assert (pk.n_in, pk.decomp_length, pk.log2_base, pk.bits, pk.mask_size) == (16, 3, 8, 32, 1)
    bits = torch.from_numpy((np.arange(32) * 7 % 3) == 1)
    packed = pack.pack_lwes(pk, api.encrypt(g, sk, bits), 64)
    phase = rlwe_phase(packed, rk)
    assert torch.equal(phase[:32] > 0, bits)
    mu = int(encode_message(1, 8))
    err = (phase[:32] - torch.where(bits, mu, -mu)).double().abs() / 2**32
    assert err.max() < 1 / 16
    batch = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (3, 8)) == 1)
    many = pack.pack_lwes(pk, api.encrypt(g, sk, batch), 64)
    for i in range(3):
        assert torch.equal(rlwe_phase(RLweSample(many.a[i]), rk)[:8] > 0, batch[i])
    with pytest.raises(ValueError, match="inputs into N=64"):
        pack.pack_lwes(pk, LweSample(torch.zeros((65, 16), dtype=torch.int32),
                                     torch.zeros(65, dtype=torch.int32)), 64)
    with pytest.raises(ValueError, match="byte-sized"):
        pack.packing_keyswitch_keygen(g, 2**-20, LweKey(sk.key.key), rk, params.rlwe,
                                      log2_base=10, device="cpu")


@pytest.mark.parametrize("bits", [32, 64])
def test_extern_product_chunks_the_batch(monkeypatch, bits):
    """With TOEPLITZ_BYTES below one digit row's Toeplitz block of the whole
    batch (2 * B * N^2 bytes), the product is split over the batch as well:
    no int8_matmul is given more than the cap, and the words equal the
    unsplit product's."""
    B, R, N, C = 6, 3, 32, 2
    rng = np.random.default_rng(bits)
    digits = torch.from_numpy(rng.integers(-128, 128, (B, R, N)).astype(np.int8))
    packed = torch.from_numpy(rng.integers(-128, 128, (C * poly.n_limbs_for(bits), R, N))
                              .astype(np.int8))
    want = poly.negacyclic_extern_product(digits, packed, bits, C)
    cap = 2 * 2 * N * N  # two digit rows of one element
    assert cap < 2 * B * N * N
    monkeypatch.setattr(poly, "TOEPLITZ_BYTES", cap)
    sizes = []
    matmul = poly.int8_matmul

    def spy(a, b):
        sizes.append(a.numel())
        return matmul(a, b)

    spy.calls = 0
    monkeypatch.setattr(poly, "int8_matmul", spy)
    got = poly.negacyclic_extern_product(digits, packed, bits, C)
    assert max(sizes) <= cap and len(sizes) == B * 2  # 6 elements x rows {0, 1}, {2}
    np.testing.assert_array_equal(got.numpy(), want.numpy())
