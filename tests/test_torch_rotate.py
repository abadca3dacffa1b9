"""Dispatch and argument checks of the blind-rotate kernel wrapper
(torus_fhe_tpu_torch/ops/cuda_rotate.py), and the kernel against its plain
version on the card.

On the CPU, ``rotate`` must take the plain version and never count a kernel
launch. The kernel tests are marked ``cuda`` and skip without a GPU; on one,
the kernel must equal the plain version word for word (exact integer
arithmetic) in both init modes.
"""

import numpy as np
import pytest
import torch

from torus_fhe_tpu_torch.boot import api
from torus_fhe_tpu_torch.boot.bootstrap import bk_geometry
from torus_fhe_tpu_torch.core import params as P
from torus_fhe_tpu_torch.core.params import SchemeParams, test_parameters as make_test_params
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock


def _twin(N=64):
    base = make_test_params(n=12, N=N)
    return SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                           "rlwe_mask_size": 2, "bk_drop_limbs": 1})


PARAMS = {"k1_N64": lambda: make_test_params(n=12, N=64),
          "k1_N256": lambda: make_test_params(n=12, N=256),
          "k2_rounded_N64": _twin}


def _setup(params, B, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    _, ck = api.make_key_pair(g, params, device=device)
    rng = np.random.default_rng(seed)
    N, C, n = params.rlwe_polynomial_degree, params.rlwe_mask_size + 1, params.lwe_size
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, C, N)).astype(np.int32))
    bara = torch.from_numpy(rng.integers(0, 2 * N, (B, n)).astype(np.int32))
    barb = torch.from_numpy(rng.integers(-N, N, B).astype(np.int32))
    tg = params.tgsw
    args = (bk_geometry(params), tg.decomp_length, tg.log2_base, tg.offset)
    return ck.bootstrap_key.fb, acc.to(device), bara.to(device), barb.to(device), args


def test_cpu_tensors_take_the_plain_version():
    fb, acc, bara, barb, args = _setup(PARAMS["k1_N64"](), 3, 0)
    before = cuda_rotate.blind_rotate_cuda.launches
    got = cuda_rotate.rotate(acc, fb, bara, *args)
    np.testing.assert_array_equal(got.numpy(), fblock.blind_rotate_fblock(acc, fb, bara, *args).numpy())
    got = cuda_rotate.rotate(None, fb, bara, *args, stepvec=(1 << 29, barb))
    want = fblock.blind_rotate_fblock(None, fb, bara, *args, stepvec=(1 << 29, barb))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert cuda_rotate.blind_rotate_cuda.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    fb, acc, bara, barb, (geom, l, lb, off) = _setup(PARAMS["k1_N64"](), 2, 1)
    before = cuda_rotate.blind_rotate_cuda.launches
    bad = [
        dict(fb=fb.to(torch.int32)),                       # key dtype
        dict(fb=fb[:, :-1]),                               # key shape
        dict(bara=bara.to(torch.int64)),                   # bara dtype
        dict(bara=bara[:, :-1]),                           # step count
        dict(acc=acc.to(torch.int64)),                     # acc dtype
        dict(acc=acc[:, :1]),                              # acc shape
        dict(geom=geom._replace(bits=64)),                 # 64-bit torus
        dict(lb=9),                                        # digits wider than a byte
        dict(stepvec=(5, barb)),                           # acc and stepvec both
    ]
    for case in bad:
        kw = dict(acc=acc, fb=fb, bara=bara, geom=geom, lb=lb, stepvec=None)
        kw.update(case)
        with pytest.raises(ValueError):
            cuda_rotate.rotate(kw["acc"], kw["fb"], kw["bara"], kw["geom"], l, kw["lb"],
                               off, stepvec=kw["stepvec"])
    with pytest.raises(ValueError):  # stepvec barb of the wrong shape
        cuda_rotate.rotate(None, fb, bara, geom, l, lb, off, stepvec=(5, barb[:1]))
    with pytest.raises(ValueError):  # the kernel itself takes CUDA tensors only
        cuda_rotate.blind_rotate_cuda(acc, fb, bara, geom, l, lb, off)
    assert cuda_rotate.blind_rotate_cuda.launches == before


def test_shared_memory_per_gate():
    """The kernel keeps C*N int32 accumulator words and l*C*N int8 digits per
    gate in shared memory: 9 KiB at tfhe_128_tpu_fast, 14 KiB at
    tfhe_128_tpu, so 16 gates fit the 227 KiB a block may use in both."""
    for p, per_gate in ((P.tfhe_parameters_128_tpu_fast(), 9216),
                        (P.tfhe_parameters_128_tpu(), 14336)):
        geom = bk_geometry(p)
        assert cuda_rotate.smem_bytes(1, geom, p.bs_decomp_length) == per_gate
        assert cuda_rotate.smem_bytes(16, geom, p.bs_decomp_length) <= 227 * 1024


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the blind-rotate kernel is CUDA only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("B", [1, 5, 40])
def test_kernel_equals_plain_version(cuda_device, name, B):
    fb, acc, bara, barb, args = _setup(PARAMS[name](), B, 2, device=cuda_device)
    before = cuda_rotate.blind_rotate_cuda.launches
    got = cuda_rotate.blind_rotate_cuda(acc, fb, bara, *args)
    want = fblock.blind_rotate_fblock(acc, fb, bara, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got = cuda_rotate.blind_rotate_cuda(None, fb, bara, *args, stepvec=(-(1 << 29), barb))
    want = fblock.blind_rotate_fblock(None, fb, bara, *args, stepvec=(-(1 << 29), barb))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cuda_rotate.blind_rotate_cuda.launches == before + 2
