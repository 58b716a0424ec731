"""Post-scan hook registry (reference pkg/scanner/post/post_scan.go):
hooks run after detection + enrichment and may insert, update, or delete
results.  Used by the module extension system.

Copy of trivy_tpu/scanner/post.py.
"""

from __future__ import annotations

_HOOKS: list = []


def register_post_scanner(hook) -> None:
    """hook: callable(results, options) -> results."""
    _HOOKS.append(hook)


def unregister_post_scanner(hook) -> None:
    try:
        _HOOKS.remove(hook)
    except ValueError:
        pass


def clear() -> None:
    _HOOKS.clear()


def scan(results, options):
    for hook in list(_HOOKS):
        results = hook(results, options)
    return results
