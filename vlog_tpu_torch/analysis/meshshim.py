"""meshshim: device choice goes through device.py and parallel/mesh.py.

The port's counterpart of the JAX package's shard_map rule, aimed at the
port's own device surface. Its entry points run on the card unless the
caller asks for the CPU, and asking for CUDA where there is none is an
error, never a silent fall back to the CPU. Two modules own that choice:

- ``device.py::resolve_device`` turns a caller's device into a
  ``torch.device`` and raises when CUDA is asked for and missing;
- ``parallel/mesh.py`` lists the visible cards
  (:func:`~vlog_tpu_torch.parallel.mesh.visible_cuda_devices`) and lays
  the meshes and grids over them.

A module that probes ``torch.cuda.is_available()`` or counts
``torch.cuda.device_count()`` itself makes a device choice of its own,
past those surfaces: the typical result is a branch that quietly runs
the CPU path when the card is missing, or a device set that disagrees
with the scheduler's.

Rule: outside ``device.py``, ``parallel/mesh.py`` and the analysis
package, no module may reference ``torch.cuda.is_available`` or
``torch.cuda.device_count`` (any receiver ending in ``cuda.``, so
``from torch import cuda`` spellings count too), nor import either name
from ``torch.cuda``.

Escape hatch: a trailing ``# meshshim-ok: <reason>`` on the line, for a
probe that chooses no device (e.g. which activities a profiler traces).
An EMPTY reason is itself a finding.
"""

from __future__ import annotations

import ast
import re

from vlog_tpu_torch.analysis.core import Finding, Module, dotted_name

RULE = "meshshim"

_SHIM = "device.py::resolve_device / parallel/mesh.py"
_PROBES = frozenset({"is_available", "device_count"})
_OK_RE = re.compile(r"#\s*meshshim-ok:\s*(.*?)\s*$")


def _exempt(mod: Module) -> bool:
    # The two surfaces themselves, and the analysis package (this file
    # quotes the banned spellings in docstrings/tests).
    return (mod.pkg_parts in (("device.py",), ("parallel", "mesh.py"))
            or mod.pkg_parts[0] == "analysis")


def _raw_uses(mod: Module):
    """(line, spelling) for every raw probe in the module."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute) and node.attr in _PROBES:
            dotted = dotted_name(node)
            if dotted is not None and (dotted.endswith("cuda." + node.attr)):
                yield node.lineno, f"{dotted}()"
        elif isinstance(node, ast.ImportFrom) and node.module == "torch.cuda":
            for alias in node.names:
                if alias.name in _PROBES:
                    yield (node.lineno,
                           f"from torch.cuda import {alias.name}")


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if _exempt(mod):
            continue
        for line, what in _raw_uses(mod):
            text = mod.lines[line - 1] if line <= len(mod.lines) else ""
            ok = _OK_RE.search(text)
            if ok is not None:
                if not ok.group(1):
                    findings.append(Finding(
                        RULE, mod.rel, line,
                        f"meshshim-ok escape without a justification "
                        f"({what})"))
                continue
            findings.append(Finding(
                RULE, mod.rel, line,
                f"raw device probe {what} — choose devices through "
                f"{_SHIM}"))
    return findings
