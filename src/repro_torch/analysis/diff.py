"""Structured diff of two fingerprint documents (``fingerprint.py``).

The counterpart of the JAX package's ``analysis/diff.py``: a recursive
walk of two JSON documents that reports every path whose value differs,
was added or was removed, so a routing, tiling or byte-model change shows
as the lines it changed rather than as a digest mismatch.
"""
from __future__ import annotations

import json

__all__ = ["diff_docs", "format_diff"]


def _join(path: str, key) -> str:
    return f"{path}[{key}]" if isinstance(key, int) else (
        f"{path}.{key}" if path else str(key))


def diff_docs(golden, current, path: str = "") -> list:
    """``[(path, golden value, current value)]`` for every leaf that
    differs; a missing side is ``"<absent>"``."""
    if isinstance(golden, dict) and isinstance(current, dict):
        out = []
        for k in sorted(set(golden) | set(current), key=str):
            out += diff_docs(golden.get(k, "<absent>"),
                             current.get(k, "<absent>"), _join(path, k))
        return out
    if isinstance(golden, list) and isinstance(current, list):
        out = []
        for i in range(max(len(golden), len(current))):
            out += diff_docs(golden[i] if i < len(golden) else "<absent>",
                             current[i] if i < len(current) else "<absent>",
                             _join(path, i))
        return out
    return [] if golden == current else [(path, golden, current)]


def _short(v) -> str:
    text = v if isinstance(v, str) else json.dumps(v, sort_keys=True)
    return text if len(text) <= 80 else text[:77] + "..."


def format_diff(diffs, limit: int = 40) -> str:
    """The diffs as lines ``path: golden -> current`` (the first
    ``limit``)."""
    lines = [f"  {p}: {_short(g)} -> {_short(c)}" for p, g, c in
             diffs[:limit]]
    if len(diffs) > limit:
        lines.append(f"  ... and {len(diffs) - limit} more")
    return "\n".join(lines)
