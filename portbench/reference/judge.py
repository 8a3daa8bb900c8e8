"""The comparison that decides `correct`: how far each served class lies
below the reference's best class, in the reference's float32 logits.

A served class that is the reference's argmax, or ties with it, reads 0.
The numbers compared are the widest gap over every answer that names a
class, and the count of answers that name none (outside [0, classes)).
"""

from __future__ import annotations

import numpy as np


def gaps(ref_logits: np.ndarray, ids: np.ndarray,
         served: np.ndarray) -> np.ndarray:
    """ref_logits float32 [P, C]; ids int [n] rows of it; served int [n]
    -> float64 [n], the reference's best logit minus the served class's."""
    ref_logits = np.asarray(ref_logits, dtype=np.float32)
    ids = np.asarray(ids, dtype=np.int64).ravel()
    served = np.asarray(served).astype(np.int64).ravel()
    if ids.shape != served.shape:
        raise ValueError(f"{ids.size} ids for {served.size} answers")
    out = np.full(ids.shape, np.inf)
    ok = (served >= 0) & (served < ref_logits.shape[1])
    rows = ref_logits[ids[ok]].astype(np.float64)
    out[ok] = rows.max(axis=1) - rows[np.arange(rows.shape[0]), served[ok]]
    return out


def widest_gap(ref_logits: np.ndarray, answers):
    """answers: iterable of (ids, served) pairs -> (the widest gap over
    the answers that name a class, 0.0 when none; how many name none)."""
    widest, invalid = 0.0, 0
    for ids, served in answers:
        g = gaps(ref_logits, ids, served)
        bad = ~np.isfinite(g)
        invalid += int(bad.sum())
        if g.size > bad.sum():
            widest = max(widest, float(g[~bad].max()))
    return widest, invalid
