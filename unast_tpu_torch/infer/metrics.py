"""Evaluation metrics of the port, mirroring `unast_tpu/infer/metrics.py`.

compute_per is the reference's jiwer WER over space-joined phoneme-id
strings: the summed edit distance over the summed reference lengths. The
JAX package takes the batch of edit distances from its native C++ library
(unast_tpu/native); the port computes them with numpy (levenshtein_batch),
to the same integers. compute_d_score counts the discriminator's correct
thresholded predictions.
"""

from typing import Sequence

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """unast_tpu/infer/metrics.py::edit_distance: token-level Levenshtein
    distance (two-row DP)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1)
    cur = np.empty(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        cur[0] = i
        sub = prev[:-1] + (np.asarray(hyp) != ref[i - 1])
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev, cur = cur, prev
    return int(prev[m])


def levenshtein_batch(ref, hyp, ref_lens, hyp_lens) -> np.ndarray:
    """Edit distance of each row pair ref[b, :ref_lens[b]], hyp[b,
    :hyp_lens[b]] ([B] int64), as unast_tpu/native's levenshtein_batch
    gives it. One DP row at a time for the whole batch: with
    a[j] = min(prev[j] + 1, prev[j-1] + cost) and a[0] = i, the row is
    cur[j] = min_k<=j (a[k] + j - k), a running minimum of a[k] - k.
    Columns past a row's hyp length and rows past its ref length are
    computed but never read."""
    ref = np.asarray(ref, np.int64)
    hyp = np.asarray(hyp, np.int64)
    ref_lens = np.asarray(ref_lens, np.int64)
    hyp_lens = np.asarray(hyp_lens, np.int64)
    b, m = hyp.shape[0], hyp.shape[1]
    rows = np.arange(b)
    col = np.arange(m + 1)
    prev = np.broadcast_to(col, (b, m + 1)).copy()
    out = prev[rows, hyp_lens].copy()          # ref length 0
    for i in range(1, int(ref_lens.max(initial=0)) + 1):
        cost = (hyp != ref[:, i - 1:i]).astype(np.int64)
        a = np.empty_like(prev)
        a[:, 0] = i
        a[:, 1:] = np.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        prev = np.minimum.accumulate(a - col, axis=1) + col
        done = ref_lens == i
        out[done] = prev[rows[done], hyp_lens[done]]
    return out


def compute_per(ground_truth, hypothesis, gt_lens, hyp_lens) -> float:
    """unast_tpu/infer/metrics.py::compute_per. ground_truth/hypothesis:
    [B, T] id arrays; lens: [B]. sum(edit) / sum(ref_len), as jiwer.wer
    over space-joined id strings."""
    gt_lens = np.asarray(gt_lens, np.int64)
    dists = levenshtein_batch(ground_truth, hypothesis, gt_lens, hyp_lens)
    return float(np.sum(dists)) / max(1, int(np.sum(gt_lens)))


def compute_d_score(outputs, targets) -> int:
    """unast_tpu/infer/metrics.py::compute_d_score: the count of
    thresholded discriminator predictions that match the rounded
    targets."""
    preds = np.round(1.0 / (1.0 + np.exp(-np.asarray(outputs, np.float64))))
    return int(np.sum(preds == np.round(np.asarray(targets, np.float64))))
