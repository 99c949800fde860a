"""Warn-once deprecation shims for the pre-`repro_torch.api` serving surface.

The old constructors (`SkewRouteDispatcher`, `ServingPipeline`) keep
working — they ARE the internals `repro_torch.api.build` composes — but
hand-wiring them is deprecated in favor of the declarative
`RouteSpec` -> `SkewRouteSession` path. Each old entry point warns
exactly once per process; the api suppresses the warning for its own
internal construction via :func:`suppress`.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

_lock = threading.Lock()
_warned: set[str] = set()
_local = threading.local()  # per-thread: api builds on one thread must
                            # not mute a hand-wiring user on another


@contextlib.contextmanager
def suppress():
    """Internal (repro_torch.api) construction: no deprecation warning."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def warn_once(key: str, message: str) -> bool:
    """Emit ``message`` as a DeprecationWarning the first time ``key`` is
    seen (and outside :func:`suppress` blocks). Returns whether it fired."""
    if getattr(_local, "depth", 0):
        return False
    with _lock:
        if key in _warned:
            return False
        _warned.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)
    return True


def reset() -> None:
    """Forget warn-once history (test hook)."""
    with _lock:
        _warned.clear()
