"""float64 references of the build's nearest-centroid and closure-replica
passes (Euclidean).

A point p with base cluster b admits replica cluster j != b when
d(p, c_j) < bt * d(p, c_b) and d(c_b, c_j) >= d(p, c_j); a pass keeps the
``n_extra`` admitted clusters of smallest distance (or SOAR score).  The
device computes in f32, so a candidate within rounding of a rule boundary,
or of another candidate in rank, may legitimately go either way; everything
else must match.  Tests hold the XLA passes to these references on small
inputs; ``chip_smoke.py`` holds sampled rows of full-size passes on the GPU
to them.
"""

from __future__ import annotations

from typing import List

import numpy as np

SLACK = 1e-4  # relative rounding slack of an f32 distance expansion


def sq_dists64(A, B) -> np.ndarray:
    """(len(A), len(B)) float64 squared Euclidean distances."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    D = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * (A @ B.T)
    return np.maximum(D, 0.0)


def closure_reference(X, base, cents, bt: float, lam: float = 0.0):
    """float64 (rank, eligible-strict, eligible-loose, tol) of the closure
    rule for rows ``X`` with base clusters ``base``; strict/loose shrink or
    grow each boundary by the rounding slack ``tol``."""
    X64 = np.asarray(X, np.float64)
    C64 = np.asarray(cents, np.float64)
    base = np.asarray(base)
    rows = np.arange(len(X64))
    D = sq_dists64(X64, C64)
    db = D[rows, base]
    cc = sq_dists64(C64[base], C64)
    not_base = np.ones_like(D, bool)
    not_base[rows, base] = False
    tol = SLACK * ((X64 ** 2).sum(1)[:, None] + (C64 ** 2).sum(1)[None, :])
    strict = (D < bt * db[:, None] - tol) & (cc >= D + tol) & not_base
    loose = (D < bt * db[:, None] + tol) & (cc >= D - tol) & not_base
    if lam:
        rdot = 0.5 * (db[:, None] + D - cc)
        rank = D + lam * rdot * rdot / np.maximum(db[:, None], 1e-30)
    else:
        rank = D
    return rank, strict, loose, tol


def replica_mismatches(ki, kd, X, base, cents, bt: float,
                       lam: float = 0.0) -> List[int]:
    """Rows of a replica pass's output (ids ``ki``, scores ``kd``, both
    (rows, n_extra), +inf marking an empty slot) that break the float64
    closure rule beyond rounding.  A row is right when its finite slots
    form a suffix-free prefix of distinct, admitted ids scored to rounding,
    and every clearly admitted id that clearly beats the row's worst kept
    score is kept."""
    ki, kd = np.asarray(ki), np.asarray(kd)
    rank, strict, loose, tol = closure_reference(X, base, cents, bt, lam)
    fin = np.isfinite(kd)
    bad = []
    for r in range(len(ki)):
        got = ki[r][fin[r]]
        ok = bool(np.all(fin[r, :-1] | ~fin[r, 1:]))  # inf only as a suffix
        ok &= len(set(got.tolist())) == len(got)
        ok &= bool(loose[r, got].all())
        if len(got):
            ok &= bool(np.all(
                np.abs(kd[r][fin[r]] - rank[r, got])
                <= 1e-4 * np.abs(rank[r, got]) + 2 * tol[r, got].max()
            ))
        if len(got) == ki.shape[1]:
            must = strict[r] & (rank[r] < rank[r, got].max() - 2 * tol[r])
        else:
            must = strict[r]
        ok &= set(np.flatnonzero(must).tolist()) <= set(got.tolist())
        if not ok:
            bad.append(r)
    return bad


def nearest_mismatches(kb, kd, X, cents) -> List[int]:
    """Rows of a nearest-centroid pass's output (ids ``kb``, distances
    ``kd``) that disagree with the float64 argmin beyond rounding: the
    chosen centroid must be nearest up to the slack, and its distance
    right to rounding."""
    kb, kd = np.asarray(kb), np.asarray(kd)
    X64 = np.asarray(X, np.float64)
    C64 = np.asarray(cents, np.float64)
    D = sq_dists64(X64, C64)
    rows = np.arange(len(X64))
    want = D.argmin(1)
    tol = SLACK * ((X64 ** 2).sum(1) + (C64 ** 2).sum(1).max())
    near = D[rows, kb] <= D[rows, want] + 2 * tol
    right = np.abs(kd - D[rows, kb]) <= 1e-4 * D[rows, kb] + tol
    return np.flatnonzero(~(near & right)).tolist()
