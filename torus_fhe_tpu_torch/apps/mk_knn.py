"""Multikey encrypted K-nearest-neighbours with the threshold-decryption tail.

Port of torus_fhe_tpu/apps/mk_knn.py: the encrypted-KNN circuit of
src/KNN_medical_data.cpp (distances, sort, majority vote and threshold
compare) over 3rd-gen multikey ciphertexts (the word circuits of
mk/gates3gen.py: every party contributes its own key, the cloud computes
under the concatenated key), and the reference's tail
``ciphertext_conversion_threshold_decryption``: the decision bit goes through
the LWE -> ring-LWE embedding and Benaloh–Leichter (3,5)-threshold decryption
with party subset {1,2,4} over a smudging-bound sweep.

For the tail the (parties, n) mask flattens into ONE LWE ciphertext under the
concatenated party key (b − Σ_p <a_p, s_p> = b − <a_flat, s_cat>), which
embeds into a degree-(parties·n) ring, not a power of two. The exact products
of threshold/decrypt.py serve rings up to MAX_EXACT_N = 4096; from 8 parties
(4,320) the limb FFT product of ops/poly.py takes the ring, on the decision's
device.

Batch-first: all train rows, columns, bit positions and test rows of a
circuit stage ride one multikey bootstrap call.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.params import SchemeParams3Gen
from ..lwe import LweKey, LweSample
from ..mk import gates3gen as g3
from ..mk.keys3gen import MKCloudKey, default_forms, mk_cloud_keygen, mk_party_keygen
from ..mk.samples import MKLweSample, mk_decrypt, mk_int_encrypt
from ..threshold.convert import tlwe_from_lwe
from .knn import load_cardio_csv, plaintext_oracle, threshold_sweep, tree_sum


def mk_abs_difference(ck: MKCloudKey, a: MKLweSample, b: MKLweSample,
                      width: int) -> MKLweSample:
    """|a - b|: both subtraction directions are ONE circuit over an extra
    axis, then the sign bit of a-b selects."""
    both_a = MKLweSample(torch.stack([a.a, b.a], 1), torch.stack([a.b, b.b], 1))
    both_b = MKLweSample(torch.stack([b.a, a.a], 1), torch.stack([b.b, a.b], 1))
    d = g3.mk_subtract(ck, both_a, both_b, width)  # (width, 2, ...)
    d1 = MKLweSample(d.a[:, 0], d.b[:, 0])  # a - b
    d2 = MKLweSample(d.a[:, 1], d.b[:, 1])  # b - a
    return g3.mk_mux_word(ck, g3._bit(d1, width - 1), d2, d1)


def mk_manhattan_distance(ck: MKCloudKey, row1: MKLweSample, row2: MKLweSample,
                          width: int) -> MKLweSample:
    """Σ_cols |row1_c - row2_c| with a tree sum over the column axis (the
    last batch axis, before (parties, n))."""
    diffs = mk_abs_difference(ck, row1, row2, width)  # (width, ..., cols, P, n)
    terms = [MKLweSample(diffs.a[..., c, :, :], diffs.b[..., c])
             for c in range(diffs.b.shape[-1])]
    return tree_sum(terms, lambda x, y, z: g3.mk_add(ck, x, y, z, width),
                    lambda x: g3.mk_word_constant(ck, x, False))


def mk_knn_predict(ck: MKCloudKey, train_rows: MKLweSample, train_labels: MKLweSample,
                   test_row: MKLweSample, k: int, width: int) -> MKLweSample:
    """Multikey encrypted KNN decision bit: batched distances against all
    train rows, bubble sort by distance with the labels as payload, majority
    vote of the k nearest through ripple adders, threshold compare.

    train_rows: (width, rows, cols, parties, n); train_labels:
    (1, rows, parties, n); test_row: (width, cols, parties, n). Any further
    batch axis (the test rows of ``run_mk_pipeline``) goes after ``rows``.
    """
    n_rows = train_rows.b.shape[1]
    test = MKLweSample(test_row.a[:, None].expand(train_rows.a.shape),
                       test_row.b[:, None].expand(train_rows.b.shape))
    dists = mk_manhattan_distance(ck, train_rows, test, width)  # (width, rows, ..., P, n)
    dist_words = [MKLweSample(dists.a[:, r], dists.b[:, r]) for r in range(n_rows)]
    label_words = [MKLweSample(train_labels.a[:, r], train_labels.b[:, r])
                   for r in range(n_rows)]
    _, (sorted_labels,) = g3.mk_bubble_sort(ck, dist_words, width, [label_words])

    cnt_width = max(2, k.bit_length() + 1)
    # the zero bit carries the label words' trailing batch axes
    zero_bit = g3.mk_word_constant(ck, sorted_labels[0], False)

    def widen(bit_word: MKLweSample) -> MKLweSample:
        return g3._stack_bits([g3._bit(bit_word, 0)] + [zero_bit] * (cnt_width - 1))

    count = widen(sorted_labels[0])
    for i in range(1, k):
        count = g3.mk_add(ck, count, widen(sorted_labels[i]), zero_bit, cnt_width)

    # predict 1 iff count > k/2  <=>  NOT(count < floor(k/2)+1)
    thresh_bits = torch.tensor([(k // 2 + 1) >> i & 1 == 1 for i in range(cnt_width)])
    thresh_bits = thresh_bits.reshape((cnt_width,) + (1,) * (count.b.dim() - 1))
    thresh = g3.mk_gate_constant(ck, thresh_bits.expand(count.b.shape))
    less = g3._bit(g3.mk_subtract(ck, count, thresh, cnt_width), cnt_width - 1)
    return g3.mk_gate_not(ck, less)


def mk_knn_predict_rows(ck: MKCloudKey, train_rows: MKLweSample, train_labels: MKLweSample,
                        test_rows: MKLweSample, k: int, width: int) -> MKLweSample:
    """``mk_knn_predict`` for T test rows in ONE circuit: test_rows (width,
    T, cols, parties, n); the train words are broadcast to a test-row axis
    after their row axis. Returns the T decision bits (T, parties, n)."""
    T = test_rows.b.shape[1]

    def with_tests(x: MKLweSample) -> MKLweSample:  # (w, rows, ...) -> (w, rows, T, ...)
        return MKLweSample(x.a[:, :, None].expand(x.a.shape[:2] + (T,) + x.a.shape[2:]),
                           x.b[:, :, None].expand(x.b.shape[:2] + (T,) + x.b.shape[2:]))

    return mk_knn_predict(ck, with_tests(train_rows), with_tests(train_labels), test_rows, k,
                          width)


def mk_flatten(x: MKLweSample) -> LweSample:
    """A multikey ciphertext IS one LWE ciphertext under the concatenated
    party key: the (parties, n) mask flattened."""
    return LweSample(x.a.reshape(tuple(x.a.shape[:-2]) + (-1,)), x.b)


def concat_lwe_key(lwe_keys: Sequence[LweKey]) -> LweKey:
    return LweKey(torch.cat([k.key for k in lwe_keys]))


def mk_threshold_tail(decision: MKLweSample, lwe_keys: Sequence[LweKey],
                      generator: torch.Generator, t: int = 3, p: int = 5,
                      subset: Sequence[int] = (1, 2, 4), bound_start: float = 0.0125,
                      bound_stop: float = 1e-3) -> list[dict]:
    """The reference's tail on the multikey decision bit: LWE -> ring-LWE
    embedding, (t, p) Benaloh–Leichter sharing of the joint ring key,
    threshold decryption with ``subset`` across the smudging-bound sweep
    0.0125 -> 1e-3 (halving), sign-decoding coefficient 0 at each bound. On
    the decision's device; a ring above 4,096 takes the limb FFT product."""
    key_cat = concat_lwe_key(lwe_keys).key.to(decision.a.device)
    return threshold_sweep(tlwe_from_lwe(mk_flatten(decision)),
                           key_cat.reshape(1, -1).to(torch.int32), generator, t, p, subset,
                           bound_start, bound_stop)


def mk_encrypt_dataset(generator: torch.Generator, lwe_keys, features: np.ndarray,
                       labels: np.ndarray, width: int, params: SchemeParams3Gen):
    """Bitwise multikey encryption of an integer feature matrix and its label
    bits (mk_int_encrypt_3gen over the whole dataset)."""
    return (mk_int_encrypt(generator, lwe_keys, features, width, params),
            mk_int_encrypt(generator, lwe_keys, labels, 1, params))


def run_mk_pipeline(generator: torch.Generator, params: SchemeParams3Gen, parties: int,
                    csv_path: str, k: int = 5, width: int = 8, train_rows: int = 5,
                    test_rows: int = 1, feature_cols=None, scale_shift: int = 0, forms=None,
                    threshold_tail: bool = True, progress=None, device=None) -> dict:
    """k-party encrypted-KNN end to end: per-party keygen, multikey cloud
    keygen (``forms`` None: ``mk.default_forms``), multikey encryption of the
    CSV rows, ONE encrypted prediction circuit for all test rows (they ride
    a batch axis after the train-row axis), multikey decryption, accuracy
    tally, and the threshold tail per test row. ``device`` None is the card
    (core/device.resolve_device)."""
    device = resolve_device(device)
    if forms is None:
        forms = default_forms(params, parties)
    sks = [mk_party_keygen(generator, params, device=device) for _ in range(parties)]
    ck = mk_cloud_keygen(generator, sks, params, device=device, forms=forms)
    lwe_keys = [sk.lwe for sk in sks]

    tr_f, tr_l, te_f, te_l = load_cardio_csv(csv_path, train_rows, test_rows, feature_cols)
    tr_f, te_f = tr_f >> scale_shift, te_f >> scale_shift
    feats, labs = mk_encrypt_dataset(generator, lwe_keys, tr_f, tr_l, width, params)
    test_word = mk_int_encrypt(generator, lwe_keys, te_f, width, params)  # (width, T, ...)
    decision = mk_knn_predict_rows(ck, feats, labs, test_word, k, width)
    predictions = [int(b) for b in mk_decrypt(lwe_keys, decision).reshape(-1).tolist()]
    tails = []
    for i in range(len(predictions)):
        if threshold_tail:
            tails.append(mk_threshold_tail(MKLweSample(decision.a[i], decision.b[i]),
                                           lwe_keys, generator))
        if progress is not None:
            progress(i, predictions[i])
    oracle = plaintext_oracle(tr_f, tr_l, te_f, k, width)
    correct = sum(int(p == int(t)) for p, t in zip(predictions, te_l))
    return {"predictions": predictions, "labels": te_l.tolist(),
            "oracle": oracle, "matches_oracle": predictions == oracle,
            "correct": correct, "total": len(predictions),
            "accuracy": correct / max(1, len(predictions)),
            "threshold_tail": tails, "parties": parties, "k": k, "width": width}
