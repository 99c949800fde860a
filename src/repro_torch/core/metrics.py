"""KGQA evaluation metrics: Hit@1 and F1 over answer sets (paper §4.1)."""

from __future__ import annotations

from typing import Iterable, Sequence


def _norm(ans: str) -> str:
    return " ".join(str(ans).strip().lower().split())


def hit_at_1(predictions: Sequence[str], gold: Iterable[str]) -> float:
    """1.0 if the top prediction matches any gold answer."""
    if not predictions:
        return 0.0
    golds = {_norm(g) for g in gold}
    return 1.0 if _norm(predictions[0]) in golds else 0.0


def f1_score(predictions: Sequence[str], gold: Iterable[str]) -> float:
    """Set F1 between predicted answers and gold answers."""
    pset = {_norm(p) for p in predictions if str(p).strip()}
    gset = {_norm(g) for g in gold}
    if not pset and not gset:
        return 1.0
    if not pset or not gset:
        return 0.0
    tp = len(pset & gset)
    if tp == 0:
        return 0.0
    precision = tp / len(pset)
    recall = tp / len(gset)
    return 2 * precision * recall / (precision + recall)


def batch_metrics(batch_predictions: Sequence[Sequence[str]],
                  batch_gold: Sequence[Iterable[str]]) -> dict[str, float]:
    if len(batch_predictions) != len(batch_gold):
        raise ValueError("prediction/gold batch length mismatch")
    n = max(len(batch_gold), 1)
    hits = sum(hit_at_1(p, g) for p, g in zip(batch_predictions, batch_gold))
    f1s = sum(f1_score(p, g) for p, g in zip(batch_predictions, batch_gold))
    return {"hit@1": hits / n, "f1": f1s / n}
