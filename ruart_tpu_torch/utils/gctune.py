"""Generational-GC tuning for the allocation-heavy host pipeline — copy of
``ruart_tpu/utils/gctune.py``.

The featurize/item-build/collate path allocates millions of small dicts
and lists per 256-batch; CPython's default gen-0 threshold (700) then
runs a cyclic collection every few hundred allocations, which finds
nothing: the pipeline's objects are almost entirely acyclic.

Applied at entry points only (the CLIs and ``InferenceEngine``) — a
library should not mutate process-global GC state on import. Opt out with
the ``NO_GC_TUNE`` conf key.
"""

from __future__ import annotations

import gc

_THRESHOLDS = (100_000, 100, 100)


def tune_gc(opt=None) -> bool:
    """Raise the gen-0 collection threshold for host-pipeline throughput.
    Returns True when applied; respects the ``NO_GC_TUNE`` conf key
    (reference conf semantics: key *presence* disables)."""
    if opt is not None and "NO_GC_TUNE" in opt:
        return False
    gc.set_threshold(*_THRESHOLDS)
    return True
