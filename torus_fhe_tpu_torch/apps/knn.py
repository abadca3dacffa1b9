"""Encrypted K-nearest-neighbours over homomorphic integer words.

Port of torus_fhe_tpu/apps/knn.py (the encrypted KNN of
src/KNN_medical_data.cpp): bitwise-encrypted feature rows, the Manhattan
distance to every train row (|a-b| by two differences and a sign-select MUX),
a bubble sort of the rows by distance carrying the labels, and the majority
vote of the k nearest labels through ripple adders and a threshold compare.
All train rows ride the batch axis: the distances are one batched gate
program.

The absolute value selects on the sign bit (bit width-1) of the difference,
not on its LSB as the reference does.

The threshold tail (LWE -> ring-LWE embedding, Benaloh–Leichter sharing,
t-of-p decryption) runs on the device of the decision, with the ported
threshold package. Randomness comes from one ``torch.Generator`` passed down.
"""

from __future__ import annotations

import numpy as np
import torch

from ..boot import gates
from ..boot.api import CloudKey, SecretKey, decrypt
from ..circuits import words
from ..lwe import LweSample
from ..threshold.convert import tlwe_from_lwe
from ..threshold.decrypt import threshold_decrypt
from ..threshold.shares import share_secret_streaming


def abs_difference(ck: CloudKey, a: LweSample, b: LweSample, width: int) -> LweSample:
    """|a - b| = (a-b) < 0 ? (b-a) : (a-b)."""
    d1 = words.subtract(ck, a, b, width)  # a - b, top bit = sign
    d2 = words.subtract(ck, b, a, width)
    return words.mux_word(ck, words.bit(d1, width - 1), d2, d1, width)


def tree_sum(terms: list, add, zero):
    """Σ terms by a pairwise tree: ``add(x, y, zero(x))`` per pair, half the
    sequential adder depth of a linear accumulation."""
    while len(terms) > 1:
        nxt = [add(terms[i], terms[i + 1], zero(terms[i])) for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def manhattan_distance(ck: CloudKey, row1: LweSample, row2: LweSample,
                       width: int) -> LweSample:
    """Σ_cols |row1_c - row2_c|: rows are bit-axis words with a trailing
    column axis (width, ..., cols, n); the per-column |diff| is one batched
    circuit, then a tree sum over columns."""
    diffs = abs_difference(ck, row1, row2, width)  # (width, ..., cols)
    terms = [LweSample(diffs.a[..., c, :], diffs.b[..., c]) for c in range(diffs.b.shape[-1])]
    return tree_sum(terms, lambda x, y, z: words.add(ck, x, y, z, width),
                    lambda x: gates.gate_constant(ck, torch.zeros(x.b.shape[1:], dtype=torch.bool)))


def knn_predict(ck: CloudKey, train_rows: LweSample, train_labels: LweSample,
                test_row: LweSample, k: int, width: int) -> LweSample:
    """Encrypted KNN decision bit: the majority label among the k nearest.

    train_rows: (width, rows, cols, n) encrypted feature words;
    train_labels: (1, rows, n) encrypted label bits; test_row: (width, cols, n).
    """
    n_rows = train_rows.b.shape[1]
    # the test row against all train rows at once: one batched distance
    test = LweSample(test_row.a[:, None].expand(train_rows.a.shape),
                     test_row.b[:, None].expand(train_rows.b.shape))
    dists = manhattan_distance(ck, train_rows, test, width)  # (width, rows)
    dist_words = [LweSample(dists.a[:, r], dists.b[:, r]) for r in range(n_rows)]
    label_words = [LweSample(train_labels.a[:, r], train_labels.b[:, r]) for r in range(n_rows)]
    _, (sorted_labels,) = words.bubble_sort(ck, dist_words, width, [label_words])

    # majority vote: count the k nearest labels with ripple adders
    cnt_width = max(2, k.bit_length() + 1)
    zero_bit = gates.gate_constant(ck, torch.zeros((), dtype=torch.bool))

    def widen(bit_word):
        return words.stack_bits([words.bit(bit_word, 0)] + [zero_bit] * (cnt_width - 1))

    count = widen(sorted_labels[0])
    for i in range(1, k):
        count = words.add(ck, count, widen(sorted_labels[i]), zero_bit, cnt_width)

    # predict 1 iff count > k/2  <=>  NOT(count < floor(k/2)+1)
    thresh = gates.gate_constant(ck, torch.tensor([(k // 2 + 1) >> i & 1 == 1
                                                   for i in range(cnt_width)]))
    return gates.gate_not(ck, words.less_than(ck, count, thresh, cnt_width))


def threshold_sweep(ring, key_poly: torch.Tensor, generator: torch.Generator, t: int, p: int,
                    subset, bound_start: float, bound_stop: float) -> list[dict]:
    """(t, p)-share ``key_poly`` (1, N) and threshold-decrypt the ring
    sample with ``subset`` at smudging bounds bound_start, /2, ... above
    bound_stop; each row gives the sign of coefficient 0."""
    repo = share_secret_streaming(key_poly, t, p, generator)
    results = []
    bound = bound_start
    while bound > bound_stop:
        plain = threshold_decrypt(ring, repo, list(subset), bound, generator)
        results.append({"bound": bound, "bit": int(plain.reshape(-1)[0].item() > 0)})
        bound /= 2
    return results


def threshold_tail(decision: LweSample, sk: SecretKey, generator: torch.Generator, t: int = 3,
                   p: int = 5, subset=(1, 2, 4), bound_start: float = 0.0125,
                   bound_stop: float = 1e-3) -> list[dict]:
    """The reference's application tail
    (ciphertext_conversion_threshold_decryption): embed the decision bit into
    ring-LWE (TLweFromLwe), Benaloh–Leichter (3,5)-share the ring key, and
    threshold-decrypt with party subset {1,2,4} across the smudging-bound
    sweep 0.0125 -> 1e-3 (halving), sign-decoding coefficient 0. Runs on the
    decision's device."""
    key_poly = sk.key.key.reshape(1, -1).to(torch.int32)
    return threshold_sweep(tlwe_from_lwe(decision), key_poly, generator, t, p, subset,
                           bound_start, bound_stop)


def encrypt_dataset(generator: torch.Generator, sk: SecretKey, features: np.ndarray,
                    labels: np.ndarray, width: int):
    """Bitwise-encrypt an integer feature matrix (rows, cols) and label bits."""
    return (words.int_encrypt(generator, sk, features, width),
            words.int_encrypt(generator, sk, labels, 1))


def load_cardio_csv(path: str, train_rows: int = 5, test_rows: int = 1,
                    feature_cols=None, label_col: int = -1):
    """Parse the cardio CSV of KNN_medical_data (inputDataSet): a header
    line then integer rows (floats truncate like the reference's
    ``ss >> x``). Column 0 is an id and the last column the label by
    default. Returns (train_features, train_labels, test_features,
    test_labels) int arrays."""
    rows = []
    with open(path) as f:
        f.readline()
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append([int(float(w)) for w in line.split(",")])
            if len(rows) == train_rows + test_rows:
                break
    data = np.asarray(rows, np.int64)
    if feature_cols is None:
        feature_cols = list(range(1, data.shape[1] - 1))
    feats = data[:, feature_cols]
    labels = data[:, label_col]
    return feats[:train_rows], labels[:train_rows], feats[train_rows:], labels[train_rows:]


def plaintext_oracle(tr_f: np.ndarray, tr_l: np.ndarray, te_f: np.ndarray, k: int,
                     width: int) -> list[int]:
    """Bit-level oracle of the encrypted circuit (single-key and multikey
    alike): Manhattan distances mod 2^width, the exact bubble-sort
    compare-swap semantics (the sign bit of a - b decides; ties swap),
    majority over the first k labels."""
    preds = []
    mask = (1 << width) - 1

    def circuit_abs(a: int, b: int) -> int:
        d1, d2 = (a - b) & mask, (b - a) & mask
        return d2 if (d1 >> (width - 1)) & 1 else d1

    for row in te_f:
        d = []
        for r in range(tr_f.shape[0]):
            s = 0
            for c in range(tr_f.shape[1]):
                s = (s + circuit_abs(int(tr_f[r, c]), int(row[c]))) & mask
            d.append(s)
        pairs = [(d[i], int(tr_l[i])) for i in range(len(d))]
        m = len(pairs)
        for i in range(m - 1):
            for j in range(m - 1 - i):
                a, b = pairs[j][0], pairs[j + 1][0]
                if not ((a - b) & mask) >> (width - 1) & 1:
                    pairs[j], pairs[j + 1] = pairs[j + 1], pairs[j]
        preds.append(int(sum(lbl for _, lbl in pairs[:k]) > k // 2))
    return preds


def run_pipeline(generator: torch.Generator, sk: SecretKey, ck: CloudKey, csv_path: str,
                 k: int = 5, width: int = 8, train_rows: int = 5, test_rows: int = 1,
                 feature_cols=None, scale_shift: int = 0,
                 with_threshold_tail: bool = False) -> dict:
    """End-to-end encrypted-KNN accuracy pipeline: load the CSV, encrypt
    train and test rows, predict every test row homomorphically, decrypt, and
    tally accuracy against the plaintext labels; ``oracle`` is the circuit's
    plaintext answer. ``scale_shift`` right-shifts features so that the
    largest distances fit in ``width`` bits."""
    tr_f, tr_l, te_f, te_l = load_cardio_csv(csv_path, train_rows, test_rows, feature_cols)
    tr_f, te_f = tr_f >> scale_shift, te_f >> scale_shift
    feats, labs = encrypt_dataset(generator, sk, tr_f, tr_l, width)
    predictions, tails = [], []
    for i in range(te_f.shape[0]):
        test_word = words.int_encrypt(generator, sk, te_f[i], width)
        decision = knn_predict(ck, feats, labs, test_word, k, width)
        predictions.append(int(decrypt(sk, decision).item()))
        if with_threshold_tail:  # the reference runs the tail per test row
            tails.append(threshold_tail(decision, sk, generator))
    correct = sum(int(p == int(t)) for p, t in zip(predictions, te_l))
    out = {"predictions": predictions, "labels": te_l.tolist(),
           "oracle": plaintext_oracle(tr_f, tr_l, te_f, k, width),
           "correct": correct, "total": len(predictions),
           "accuracy": correct / max(1, len(predictions))}
    if with_threshold_tail:
        out["threshold_tail"] = tails
    return out
