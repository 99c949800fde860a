"""JSON key round-trips, centralized.

JSON objects only have string keys, but the serving stack keys its
per-tier dicts by int tier id (``PipelineTelemetry.tier_counts``,
``DispatcherStats.tier_counts``, admission's per-tier pressure/spill
maps). Every ``state_dict``/``load_state_dict`` pair therefore needs
the same str-on-the-way-out / int-on-the-way-in coercion; before this
helper each site hand-rolled it (and ``PipelineTelemetry.snapshot``
re-coerced ad hoc). One pair of functions, shared with the
:mod:`repro_torch.obs.export` exporters.
"""

from __future__ import annotations

from typing import Callable, Mapping

__all__ = ["str_keyed", "int_keyed"]


def str_keyed(d: Mapping) -> dict:
    """JSON-safe copy of ``d`` with every key coerced to ``str``
    (values passed through). Use on the way INTO a JSON payload."""
    return {str(k): v for k, v in d.items()}


def int_keyed(d: Mapping, value: Callable = int) -> dict:
    """Copy of ``d`` with keys coerced back to ``int`` and values
    passed through ``value`` (default ``int`` — counter dicts). Use on
    the way OUT of a JSON payload."""
    return {int(k): value(v) for k, v in d.items()}
