"""Whole-tree durable-state audit and repair (the port's counterpart of
the JAX package's ``fsck/``; ``python -m sparse_coding_tpu_torch.fsck``).

Lazy exports keep ``import sparse_coding_tpu_torch.fsck`` free of numpy
until a symbol is touched; the scan path imports no torch.
"""

from __future__ import annotations

_LAZY_ATTRS = {
    "scan_tree": ("sparse_coding_tpu_torch.fsck.core", "scan_tree"),
    "run_fsck": ("sparse_coding_tpu_torch.fsck.core", "run_fsck"),
    "artifact_roots": ("sparse_coding_tpu_torch.fsck.core", "artifact_roots"),
    "repair_findings": ("sparse_coding_tpu_torch.fsck.repair", "repair_findings"),
    "Finding": ("sparse_coding_tpu_torch.fsck.findings", "Finding"),
    "Report": ("sparse_coding_tpu_torch.fsck.findings", "Report"),
    "FINDING_KINDS": ("sparse_coding_tpu_torch.fsck.findings",
                      "FINDING_KINDS"),
}

__all__ = sorted(_LAZY_ATTRS)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY_ATTRS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY_ATTRS))
