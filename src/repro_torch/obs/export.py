"""Exporters: JSONL event log, Prometheus text snapshot, and the
per-request timeline walker.

Both exporters are byte-deterministic given deterministic inputs
(seeded clock, seeded workload): JSON is dumped with sorted keys and
fixed separators; Prometheus samples come out in the registry's
sorted collect() order.

The serving stack traces at BATCH granularity — each event carries
the request ids it covers (``first_id`` + row order, or an explicit
``request_ids`` list). :func:`request_timelines` re-expands those
batch events into one ordered stage list per request id; tests (and
humans) read a request's life as::

    dispatch(tier=2) -> policy(kind=cascade, tier=2) -> spill(2->1)
      -> execute(tier=1) -> complete(latency=0.41)
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping

__all__ = ["to_jsonl", "prometheus_text", "request_timelines", "span_tree"]


# -- JSONL --------------------------------------------------------------------

def to_jsonl(events: Iterable[Mapping]) -> str:
    """One compact JSON object per line, keys sorted — byte-stable."""
    return "\n".join(
        json.dumps(e, sort_keys=True, separators=(",", ":"))
        for e in events)


# -- Prometheus text ----------------------------------------------------------

def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _labels_str(labels: Mapping[str, str], extra=()) -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    parts += [f'{k}="{v}"' for k, v in extra]
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry) -> str:
    """Prometheus exposition text for every instrument in the
    registry, grouped by metric name, samples in sorted label order."""
    lines: list[str] = []
    last_name = None
    for name, labels, inst in registry.collect():
        if name != last_name:
            lines.append(f"# TYPE {name} {inst.kind}")
            last_name = name
        if inst.kind == "histogram":
            cum = 0
            for ub, c in zip(inst.buckets, inst.counts):
                cum += c
                lines.append(f"{name}_bucket"
                             f"{_labels_str(labels, [('le', _fmt(ub))])}"
                             f" {cum}")
            lines.append(f"{name}_bucket"
                         f"{_labels_str(labels, [('le', '+Inf')])} {inst.n}")
            lines.append(f"{name}_sum{_labels_str(labels)} {_fmt(inst.total)}")
            lines.append(f"{name}_count{_labels_str(labels)} {inst.n}")
        else:
            lines.append(f"{name}{_labels_str(labels)} {_fmt(inst.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- timeline reconstruction --------------------------------------------------

def _ids_of(attrs: Mapping) -> list:
    """Request ids an event covers: explicit list, or first_id + row
    order of its per-row ``tiers`` array."""
    if "request_ids" in attrs:
        return list(attrs["request_ids"])
    if "first_id" in attrs and "tiers" in attrs:
        first = int(attrs["first_id"])
        return list(range(first, first + len(attrs["tiers"])))
    if "first_id" in attrs and "n" in attrs:
        first = int(attrs["first_id"])
        return list(range(first, first + int(attrs["n"])))
    return []


def request_timelines(events: Iterable[Mapping]) -> dict:
    """{request_id: [stage dicts, in event order]} from a JSONL-parsed
    (or live ``tracer.events()``) event stream.

    Stages carried through: ``dispatch`` (tier = the difficulty
    backend's threshold decision), ``policy`` (tier = the routing
    policy's final decision; ``tier_in`` when it differs), ``spill``
    (admission demotion, from/to), ``execute`` (the micro-batch run on
    a tier runner), ``complete`` (pool completion, when recorded).
    Every stage dict has ``stage``, ``ts``, ``trace``, ``span``.
    """
    timelines: dict[int, list[dict]] = {}

    def add(rid, stage, ev, **extra):
        entry = {"stage": stage, "ts": ev.get("ts"),
                 "trace": ev.get("trace"), "span": ev.get("span")}
        entry.update(extra)
        timelines.setdefault(int(rid), []).append(entry)

    for ev in events:
        if ev.get("kind") != "event":
            continue
        name = ev.get("name")
        attrs = ev.get("attrs", {})
        if name == "dispatch":
            tiers = attrs.get("tiers", [])
            for rid, t in zip(_ids_of(attrs), tiers):
                add(rid, "dispatch", ev, tier=int(t))
        elif name == "policy":
            tiers = attrs.get("tiers", [])
            tiers_in = attrs.get("tiers_in")
            for i, (rid, t) in enumerate(zip(_ids_of(attrs), tiers)):
                extra = {"tier": int(t), "kind": attrs.get("kind")}
                if tiers_in is not None and int(tiers_in[i]) != int(t):
                    extra["tier_in"] = int(tiers_in[i])
                add(rid, "policy", ev, **extra)
        elif name == "spill":
            frm, to = attrs.get("from", []), attrs.get("to", [])
            for i, rid in enumerate(_ids_of(attrs)):
                add(rid, "spill", ev,
                    tier=int(to[i]) if i < len(to) else None,
                    tier_in=int(frm[i]) if i < len(frm) else None)
        elif name == "execute":
            for rid in _ids_of(attrs):
                add(rid, "execute", ev, tier=int(attrs.get("tier", -1)))
        elif name == "complete":
            lat = attrs.get("latencies")
            for i, rid in enumerate(_ids_of(attrs)):
                extra = {"tier": int(attrs.get("tier", -1))}
                if lat is not None and i < len(lat):
                    extra["latency"] = float(lat[i])
                add(rid, "complete", ev, **extra)
    return timelines


def span_tree(events: Iterable[Mapping]) -> dict:
    """{span_id: node} with ``children`` links; roots have
    ``parent is None``. Raises on an end without a start."""
    nodes: dict[int, dict] = {}
    for ev in events:
        kind = ev.get("kind")
        if kind == "span_start":
            nodes[ev["span"]] = {
                "span": ev["span"], "trace": ev["trace"],
                "name": ev["name"], "parent": ev.get("parent"),
                "start": ev.get("ts"), "end": None,
                "n_events": 0, "children": [],
            }
        elif kind == "span_end":
            if ev["span"] not in nodes:
                raise ValueError(f"span_end for unknown span {ev['span']}")
            nodes[ev["span"]]["end"] = ev.get("ts")
        elif kind == "event" and ev.get("span") in nodes:
            nodes[ev["span"]]["n_events"] += 1
    for node in nodes.values():
        parent = node["parent"]
        if parent is not None:
            if parent not in nodes:
                raise ValueError(f"span {node['span']} has unknown parent "
                                 f"{parent}")
            nodes[parent]["children"].append(node["span"])
    return nodes
