"""Dispatch and argument checks of the compact-key blind-rotate kernel
(ops/cuda_rotate.blind_rotate_sel_cuda, csrc/blind_rotate_sel.cu), the
exactness bound both kernels check, and the compact kernel against its plain
version (ops/fblock.blind_rotate_streamed) on the card.

On the CPU, ``rotate_streamed`` must take the plain version and count no
kernel launch. The kernel tests are marked ``cuda`` and skip without a GPU;
on one, the compact kernel must equal the plain version word for word
(exact integer arithmetic) in both init modes, at the 3gen digit sets
(l, Bg) = (2, 2^7), (3, 2^6), (4, 2^4), at batches below, ragged against and
above one gate tile, and equal the expanded-key kernel. The kernel's indexing
is emulated on the CPU in tests/test_torch_rotate_plan.py.
"""

import numpy as np
import pytest
import torch

from torus_fhe_tpu_torch.core import params as P
from torus_fhe_tpu_torch.core.params import TGswParams
from torus_fhe_tpu_torch.mk import keys3gen
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock

# (l, log2 Bg) of the 2-, 4- and 8-party 3gen sets
DIGITS = {"l2_Bg7": (2, 7), "l3_Bg6": (3, 6), "l4_Bg4": (4, 4)}


def _setup(N, l, lb, steps, B, seed, device="cpu"):
    """A random hi-word key of the mk geometry (the kernel's arithmetic does
    not depend on the key being an encryption), its compact lines, and
    random inputs."""
    rng = np.random.default_rng(seed)
    geom = fblock.fblock_geometry(steps, N, 1, l, 32, 0)
    samples = rng.integers(-2**31, 2**31, (steps, l, 2, 2, N), dtype=np.int64).astype(np.int32)
    sel = torch.from_numpy(fblock.build_sel(samples, geom)).to(device)
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, 2, N)).astype(np.int32)).to(device)
    bara = torch.from_numpy(rng.integers(0, 2 * N, (B, steps)).astype(np.int32)).to(device)
    barb = torch.from_numpy(rng.integers(-N, N, B).astype(np.int32)).to(device)
    tg = TGswParams(l, lb, 32)
    return samples, sel, acc, bara, barb, (geom, l, lb, tg.offset)


def test_cpu_tensors_take_the_plain_streamed_version():
    _, sel, acc, bara, barb, args = _setup(64, 3, 6, 13, 3, 0)
    before = (cuda_rotate.blind_rotate_cuda.launches, cuda_rotate.blind_rotate_sel_cuda.launches)
    for a, sv in ((acc, None), (None, (1 << 29, barb))):
        got = cuda_rotate.rotate_streamed(a, sel, bara, *args, stepvec=sv)
        want = fblock.blind_rotate_streamed(a, sel, bara, *args, stepvec=sv)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (cuda_rotate.blind_rotate_cuda.launches,
            cuda_rotate.blind_rotate_sel_cuda.launches) == before


def test_sel_wrapper_rejects_what_the_kernel_does_not_take():
    _, sel, acc, bara, barb, (geom, l, lb, off) = _setup(64, 2, 7, 5, 2, 1)
    before = cuda_rotate.blind_rotate_sel_cuda.launches
    bad = [
        dict(sel=sel.to(torch.int32)),                 # key dtype
        dict(sel=sel[:, :, :-1]),                      # line length
        dict(sel=sel[..., :-1]),                       # column count
        dict(sel=fblock.expand_fblock_chunk(sel, geom)),  # the expanded key
        dict(sel=sel.permute(0, 3, 2, 1)),             # neither layout of the lines
        dict(bara=bara.to(torch.int64)),               # bara dtype
        dict(bara=bara[:, :-1]),                       # step count
        dict(acc=acc[:, :1]),                          # acc shape
        dict(stepvec=(5, barb)),                       # acc and stepvec both
        dict(acc=None, stepvec=(5, barb[:1])),         # barb shape
    ]
    for case in bad:
        kw = dict(acc=acc, sel=sel, bara=bara, geom=geom, lb=lb, stepvec=None)
        kw.update(case)
        with pytest.raises(ValueError):
            cuda_rotate.rotate_streamed(kw["acc"], kw["sel"], kw["bara"], kw["geom"], l,
                                        kw["lb"], off, stepvec=kw["stepvec"])
    # a 64-bit torus and digits wider than a byte: the kernel and its checks
    # refuse them, while ``rotate_streamed`` sends them to the torch-op scan
    for wide in (dict(geom=geom._replace(bits=64)), dict(lb=9)):
        kw = dict(geom=geom, lb=lb)
        kw.update(wide)
        assert not cuda_rotate.takes_kernel_route(kw["geom"], kw["lb"])
        with pytest.raises(ValueError):
            cuda_rotate.check_sel_args(acc, sel, bara, kw["geom"], l, kw["lb"])
        with pytest.raises(ValueError):
            cuda_rotate.blind_rotate_sel_cuda(acc, sel, bara, kw["geom"], l, kw["lb"], off)
    got = cuda_rotate.rotate_streamed(acc, sel, bara, geom, l, 9, off)
    np.testing.assert_array_equal(
        got.numpy(), fblock.blind_rotate_streamed(acc, sel, bara, geom, l, 9, off).numpy())
    with pytest.raises(ValueError):  # the kernel itself takes CUDA tensors only
        cuda_rotate.blind_rotate_sel_cuda(acc, sel, bara, geom, l, lb, off)
    assert cuda_rotate.blind_rotate_sel_cuda.launches == before


@pytest.mark.parametrize("kernel", ["expanded", "compact"])
def test_both_kernels_reject_sums_beyond_int32(kernel):
    """Every output sums R*N products of |digit| <= 2^(lb-1) and |limb| <=
    128; both kernels refuse a geometry where that bound reaches 2^31 (here
    l=4, Bg=2^8, N=2^14: 8 * 2^14 * 2^7 * 2^7 = 2^31) and take the 8-party
    set's (2^23)."""
    check = cuda_rotate.check_args if kernel == "expanded" else cuda_rotate.check_sel_args
    over = fblock.fblock_geometry(1, 2**14, 1, 4, 32, 0)
    empty = torch.zeros((1, 1, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="2\\^31"):
        check(None, empty, torch.zeros((1, 1), dtype=torch.int32), over, 4, 8,
              stepvec=(0, torch.zeros(1, dtype=torch.int32)))
    p8 = P.mktfhe_parameters_8party_3gen()
    geom = keys3gen.mk_fb_geometry(p8, 1)._replace(n=2)
    assert geom.R * geom.N * 2**(p8.gsw_log2_base - 1) * 128 == 2**23
    key = (torch.zeros((2, geom.R, 2 * geom.N, 8), dtype=torch.int8) if kernel == "compact"
           else torch.zeros((2, geom.D * geom.R * geom.bs, 8 * geom.bs), dtype=torch.int8))
    check(None, key, torch.zeros((1, 2), dtype=torch.int32), geom, 4, 4,
          stepvec=(0, torch.zeros(1, dtype=torch.int32)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compact-key kernel is CUDA only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("digits", list(DIGITS))
@pytest.mark.parametrize("N", [64, 256])
@pytest.mark.parametrize("B", [1, 37, 130, 256])
def test_sel_kernel_equals_plain_version(cuda_device, digits, N, B):
    l, lb = DIGITS[digits]
    samples, lines, acc, bara, barb, args = _setup(N, l, lb, 13, B, 2, device=cuda_device)
    sel = fblock.to_sel_kernel_layout(lines, args[0])
    assert torch.equal(sel, fblock.build_sel_key(samples, args[0], cuda_device))
    before = cuda_rotate.blind_rotate_sel_cuda.launches
    with pytest.raises(ValueError, match="compact kernel layout"):
        cuda_rotate.blind_rotate_sel_cuda(acc, lines, bara, *args)
    for a, sv in ((acc, None), (None, (-(1 << 29), barb))):
        got = cuda_rotate.blind_rotate_sel_cuda(a, sel, bara, *args, stepvec=sv)
        want = fblock.blind_rotate_streamed(a, lines, bara, *args, stepvec=sv, chunk=4)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(fblock.blind_rotate_streamed(a, sel, bara, *args, stepvec=sv), want)
        fb = fblock.build_rotate_key(samples, args[0], cuda_device)
        assert torch.equal(got, cuda_rotate.blind_rotate_cuda(a, fb, bara, *args, stepvec=sv))
    assert cuda_rotate.blind_rotate_sel_cuda.launches == before + 2
