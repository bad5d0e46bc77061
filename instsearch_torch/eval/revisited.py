"""Oxford/Paris mAP protocol, classic and revisited (the port's copy of
``instsearch_tpu/eval/revisited.py::evaluate_ranks`` and its helpers; the
port imports nothing of the JAX package). Per-query average precision over
a ranked list with junk images skipped, plus mP@k, in host numpy.

Protocol composition (Radenovic et al., arXiv:1803.11285 §4):
  easy   : positives = easy,        junk = junk + hard
  medium : positives = easy + hard, junk = junk
  hard   : positives = hard,        junk = junk + easy
"""
from __future__ import annotations

import numpy as np


def _ap_fast(ranked_ids: np.ndarray, pos: np.ndarray, junk: np.ndarray
             ) -> float:
    """Vectorized compute_ap (identical trapezoid math): the per-query AP
    loop is the host-side hot path at 105k-distractor scale."""
    r = ranked_ids
    if junk.size:
        r = r[~np.isin(r, junk)]
    idx = np.flatnonzero(np.isin(r, pos))[:len(pos)]   # effective ranks
    if idx.size == 0:
        return 0.0
    k = np.arange(1, idx.size + 1, dtype=np.float64)
    prec_after = k / (idx + 1)
    prec_before = np.where(idx == 0, 1.0, (k - 1) / np.maximum(idx, 1))
    return float(((prec_before + prec_after) / 2).sum() / len(pos))


def _patk_fast(ranked_ids: np.ndarray, pos: np.ndarray, junk: np.ndarray,
               ks: tuple[int, ...]) -> list[float]:
    """Vectorized precision_at for several k in one junk-filter pass."""
    r = ranked_ids
    if junk.size:
        r = r[~np.isin(r, junk)]
    hits = np.cumsum(np.isin(r[:max(ks)], pos))
    out = []
    for k in ks:
        j = min(k, len(hits))
        h = int(hits[j - 1]) if j else 0
        out.append(h / min(k, len(pos)))
    return out


def _protocol_sets(gnd_entry: dict, protocol: str) -> tuple[set, set]:
    easy = set(gnd_entry.get("easy", gnd_entry.get("ok", [])))
    hard = set(gnd_entry.get("hard", gnd_entry.get("good", [])))
    junk = set(gnd_entry.get("junk", []))
    if protocol == "easy":
        return easy, junk | hard
    if protocol == "medium":
        return easy | hard, junk
    if protocol == "hard":
        return hard, junk | easy
    if protocol == "classic":
        # classic Oxford/Paris: positives = good + ok, junk = junk
        return easy | hard, junk
    raise ValueError(f"unknown protocol {protocol!r}")


def evaluate_ranks(ranks: np.ndarray, gnd: list[dict], protocol: str = "medium",
                   pk: tuple[int, ...] = (1, 5, 10)) -> dict:
    """``ranks: [Q, N]`` database ids best-first per query; ``gnd`` is the
    revisited-format ground truth list. Returns mAP and mP@k (percent)."""
    aps, pks = [], []
    per_query = []
    for q, entry in enumerate(gnd):
        positives, junk = _protocol_sets(entry, protocol)
        if not positives:
            per_query.append(float("nan"))
            continue
        dt = np.asarray(ranks[q]).dtype
        pos_a = np.fromiter(positives, dtype=dt, count=len(positives))
        junk_a = np.fromiter(junk, dtype=dt, count=len(junk))
        ap = _ap_fast(ranks[q], pos_a, junk_a)
        aps.append(ap)
        per_query.append(ap)
        pks.append(_patk_fast(ranks[q], pos_a, junk_a, pk))
    out = {
        "mAP": 100.0 * float(np.mean(aps)) if aps else float("nan"),
        "num_queries": len(aps),
        "per_query_ap": per_query,
    }
    if pks:
        mp = 100.0 * np.mean(np.asarray(pks), axis=0)
        out.update({f"mP@{k}": float(v) for k, v in zip(pk, mp)})
    return out
