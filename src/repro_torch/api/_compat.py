"""Deprecation machinery for the pre-``repro_torch.api`` method matrix.

Every legacy entry point (``allocate_params`` / ``allocate_params_priced`` /
``allocate_batch`` / ``allocate_dataset``, the sharded twins, and the
per-family ``train_xgb/train_nn/train_gnn``) funnels through
``warn_deprecated``: the first call to each emits exactly one
``DeprecationWarning`` (prefixed ``"repro legacy API:"``, the reference's
text) attributed to the *caller's* module, then goes quiet. A warning
filter on that prefix and the caller's module (``repro_torch\\.``) turns
an internal call into an error, so internal code can be held to never
reach a shim while downstream callers keep their one-release grace period.

This module is dependency-free on purpose: the serve and pipeline layers
import it without pulling the facade (``repro_torch.api.allocator``) into
their import graph.
"""
from __future__ import annotations

import sys
import warnings
from typing import Set, Tuple

__all__ = ["warn_deprecated", "reset_deprecation_warnings", "PREFIX"]

PREFIX = "repro legacy API:"

_warned: Set[Tuple[str, str]] = set()


def warn_deprecated(name: str, replacement: str, *, stacklevel: int = 3
                    ) -> None:
    """Emit the one-time ``DeprecationWarning`` for legacy method ``name``.

    ``stacklevel=3`` attributes the warning to the shim's caller (frame 1 is
    this helper, frame 2 the shim itself), so a warning filter can tell
    internal callers from downstream users. The once-registry is keyed per
    (method, calling module): a downstream caller warming the registry for
    ``name`` must not swallow a later internal call's warning.
    """
    try:
        caller = sys._getframe(stacklevel - 1).f_globals.get("__name__", "?")
    except ValueError:
        caller = "?"
    key = (name, caller)
    if key in _warned:
        return
    warnings.warn(
        f"{PREFIX} {name} is deprecated and will be removed next release; "
        f"use {replacement}",
        DeprecationWarning, stacklevel=stacklevel)
    # register only after a successful warn: when a filter escalates the
    # warning to an error, every call keeps erroring instead of going
    # silent after the first swallowed raise
    _warned.add(key)


def reset_deprecation_warnings() -> None:
    """Forget which legacy methods already warned (test isolation hook)."""
    _warned.clear()
