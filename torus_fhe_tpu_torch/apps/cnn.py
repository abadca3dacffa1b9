"""Encrypted convolution (CNN layer) over single-key word ciphertexts.

Port of torus_fhe_tpu/apps/cnn.py, the encrypted counterpart of the conv
layers of 3-gen-mk-tfhe/CNN.jl. The input is encrypted bit-sliced, and every
(filter, output position) word rides the trailing batch axes, so the whole
layer's ripple-carry adder network is one sequence of batched bootstraps.

Layout: an encrypted image is one LweSample word with axes
(width, H, W, ..., n) (volume: (width, D, H, W, ..., n)), the word layout of
circuits/words.py with the spatial axes as batch axes. Patch extraction,
multiplication by a plaintext weight (shift and add) and negative weights
(two's complement) are ciphertext rearrangements and gate circuits; nothing
is decrypted.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..boot import gates
from ..boot.api import CloudKey
from ..circuits import words
from ..lwe import LweSample


def _zeros(ck: CloudKey, shape) -> LweSample:
    return gates.gate_constant(ck, torch.zeros(tuple(shape), dtype=torch.bool))


def shift_left(ck: CloudKey, word: LweSample, s: int, width: int) -> LweSample:
    """word << s within a fixed ``width``: s trivial-zero bits below, the top
    s bits dropped. A free ciphertext rearrangement."""
    if s == 0:
        return word
    zero = _zeros(ck, (s,) + tuple(word.b.shape[1:]))
    return LweSample(torch.cat([zero.a, word.a[: width - s]]),
                     torch.cat([zero.b, word.b[: width - s]]))


def scale_by_plaintext(ck: CloudKey, word: LweSample, c: int, width: int) -> LweSample:
    """word * c for a plaintext integer c (mod 2^width), by shift and add.

    A negative c uses -x = ~x + 1 folded into one more addition. Cost:
    popcount(|c|) - 1 word additions, one more when c < 0.
    """
    neg = c < 0
    c = -c if neg else c
    acc = None
    for s in range(width):
        if (c >> s) & 1:
            term = shift_left(ck, word, s, width)
            if acc is None:
                acc = term
            else:
                acc = words.add(ck, acc, term, _zeros(ck, acc.b.shape[1:]), width)
    if acc is None:  # c == 0: a width-bit zero word
        return _zeros(ck, (width,) + tuple(word.b.shape[1:]))
    if neg:
        one = gates.gate_constant(ck, torch.ones(acc.b.shape[1:], dtype=torch.bool))
        acc = words.add(ck, words.ones_complement(ck, acc), _zeros(ck, acc.b.shape), one, width)
    return acc


def _patches(x: torch.Tensor, k: int, stride: int, dims: int) -> torch.Tensor:
    """(width, S_1..S_dims, ...) -> (width, k^dims, O_1..O_dims, ...): the
    taps in C order of the kernel's axes."""
    outs = [(s - k) // stride + 1 for s in x.shape[1:1 + dims]]
    taps = []
    for offs in itertools.product(range(k), repeat=dims):
        idx = (slice(None),) + tuple(slice(o, o + stride * n, stride) for o, n in zip(offs, outs))
        taps.append(x[idx])
    return torch.stack(taps, dim=1)


def extract_patches(image: LweSample, kernel_size: int, stride: int = 1) -> LweSample:
    """(width, H, W, ...) word image -> (width, kh*kw, oh, ow, ...) stacked
    patch words. Pure indexing, free on ciphertexts."""
    return LweSample(_patches(image.a, kernel_size, stride, 2),
                     _patches(image.b, kernel_size, stride, 2))


def extract_patches_3d(vol: LweSample, kernel_size: int, stride: int = 1) -> LweSample:
    """(width, D, H, W, ...) word volume -> (width, kd*kh*kw, od, oh, ow, ...)
    stacked patch words. Pure indexing, free on ciphertexts."""
    return LweSample(_patches(vol.a, kernel_size, stride, 3),
                     _patches(vol.b, kernel_size, stride, 3))


def _conv(ck: CloudKey, patches: LweSample, weights: np.ndarray, width: int) -> LweSample:
    """Σ_t weights[f, t] * patch t for every filter f: patches (width, T,
    O..., ...), weights (F, T) ints. Returns (width, F, O..., ...). Distinct
    weights need distinct shift patterns, so filters loop and every output
    position of a filter is batched; the accumulation batches all filters."""
    acc = None
    for t in range(weights.shape[1]):
        tap = LweSample(patches.a[:, t], patches.b[:, t])
        terms = [scale_by_plaintext(ck, tap, int(w), width) for w in weights[:, t]]
        term = LweSample(torch.stack([x.a for x in terms], dim=1),
                         torch.stack([x.b for x in terms], dim=1))
        acc = term if acc is None else words.add(ck, acc, term, _zeros(ck, term.b.shape[1:]),
                                                 width)
    return acc


def conv2d(ck: CloudKey, image: LweSample, kernels: np.ndarray, width: int,
           stride: int = 1) -> LweSample:
    """Valid-padding encrypted conv2d with plaintext integer filters.

    image: word LweSample (width, H, W, ...); kernels: (F, kh, kw) ints,
    square. Returns (width, F, oh, ow, ...): every filter and output position
    on the batch axes, so the adder network is one gate sequence for the
    whole layer."""
    kernels = np.asarray(kernels)
    F, kh, kw = kernels.shape
    if kh != kw:
        raise ValueError(f"square kernels only, got {kh}x{kw}")
    return _conv(ck, extract_patches(image, kh, stride), kernels.reshape(F, -1), width)


def conv3d(ck: CloudKey, vol: LweSample, kernels: np.ndarray, width: int,
           stride: int = 1) -> LweSample:
    """Valid-padding encrypted volumetric conv3d with plaintext int filters:
    vol (width, D, H, W, ...); kernels (F, k, k, k) ints. Returns
    (width, F, od, oh, ow, ...)."""
    kernels = np.asarray(kernels)
    F, kd, kh, kw = kernels.shape
    if not kd == kh == kw:
        raise ValueError(f"cubic kernels only, got {kd}x{kh}x{kw}")
    return _conv(ck, extract_patches_3d(vol, kd, stride), kernels.reshape(F, -1), width)


def conv3d_reference(vol: np.ndarray, kernels: np.ndarray, stride: int = 1) -> np.ndarray:
    """Plaintext volumetric oracle for conv3d."""
    kernels = np.asarray(kernels)
    F, kd, kh, kw = kernels.shape
    D, H, W = vol.shape
    od = (D - kd) // stride + 1
    oh = (H - kh) // stride + 1
    ow = (W - kw) // stride + 1
    out = np.zeros((F, od, oh, ow), np.int64)
    for f in range(F):
        for d in range(od):
            for i in range(oh):
                for j in range(ow):
                    blk = vol[d * stride:d * stride + kd, i * stride:i * stride + kh,
                              j * stride:j * stride + kw]
                    out[f, d, i, j] = int((blk * kernels[f]).sum())
    return out


def conv2d_reference(image: np.ndarray, kernels: np.ndarray, stride: int = 1) -> np.ndarray:
    """Plaintext oracle for conv2d (the indexing of CNN.jl)."""
    kernels = np.asarray(kernels)
    F, kh, kw = kernels.shape
    H, W = image.shape
    oh = (H - kh) // stride + 1
    ow = (W - kw) // stride + 1
    out = np.zeros((F, oh, ow), np.int64)
    for f in range(F):
        for i in range(oh):
            for j in range(ow):
                out[f, i, j] = int((image[i * stride:i * stride + kh,
                                          j * stride:j * stride + kw] * kernels[f]).sum())
    return out
