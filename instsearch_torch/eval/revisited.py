"""Oxford/Paris mAP protocol, classic and revisited (the port's copy of
``instsearch_tpu/eval/revisited.py``: ``compute_ap``, ``precision_at``,
``evaluate_ranks``, ``evaluate_scores`` and their helpers; the port imports
nothing of the JAX package). Per-query average precision over a ranked list
with junk images skipped, plus mP@k, in host numpy.

Protocol composition (Radenovic et al., arXiv:1803.11285 §4):
  easy   : positives = easy,        junk = junk + hard
  medium : positives = easy + hard, junk = junk
  hard   : positives = hard,        junk = junk + easy
"""
from __future__ import annotations

import numpy as np


def compute_ap(ranked_ids: np.ndarray, positives: set, junk: set) -> float:
    """Average precision with junk skipping (trapezoidal, official-kit form).

    ``ranked_ids``: database ids best-first. Junk entries are removed from
    the list (neither helping nor hurting); AP integrates precision over the
    recall steps at each positive hit.
    """
    if not positives:
        return float("nan")
    ap = 0.0
    hits = 0
    effective_rank = 0  # rank among non-junk entries
    recall_step = 1.0 / len(positives)
    for db_id in ranked_ids:
        if db_id in junk:
            continue
        if db_id in positives:
            precision_before = hits / effective_rank if effective_rank else 1.0
            hits += 1
            precision_after = hits / (effective_rank + 1)
            ap += (precision_before + precision_after) / 2.0 * recall_step
        effective_rank += 1
        if hits == len(positives):
            break
    return ap


def precision_at(ranked_ids: np.ndarray, positives: set, junk: set,
                 k: int) -> float:
    """P@k with junk skipping; if fewer than k positives exist the
    denominator is min(k, #positives) (revisited-kit convention)."""
    if not positives:
        return float("nan")
    hits = 0
    seen = 0
    for db_id in ranked_ids:
        if db_id in junk:
            continue
        seen += 1
        if db_id in positives:
            hits += 1
        if seen == k:
            break
    return hits / min(k, len(positives))


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


def evaluate_scores(scores: np.ndarray, gnd: list[dict],
                    protocol: str = "medium", **kw) -> dict:
    """Convenience: ``scores [Q, N]`` similarity matrix -> protocol metrics
    (``evaluate_ranks`` of each row's ``argsort`` of the negated scores)."""
    ranks = np.argsort(-np.asarray(scores), axis=1)
    return evaluate_ranks(ranks, gnd, protocol, **kw)
