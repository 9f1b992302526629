"""Project-invariant static analysis (see core.py for the framework).

``run_passes()`` is the programmatic entry (the tier-1 gate test calls
it); ``python -m vlog_tpu_torch.analysis`` is the CLI. Pass registry:

- ``asyncblock``      blocking calls inside async handlers
- ``lockdiscipline``  guarded-by fields touched outside their lock
- ``epochfence``      claim-gated Worker-API writes reach the epoch fence
- ``tracehop``        thread hand-offs in traced modules carry context
- ``registry``        knob/metric/failpoint/span registries vs docs
- ``meshshim``        device probes go through device.py / parallel/mesh
- ``pallasshim``      CUDA kernel code stays in the ops/ kernel modules
- ``lockorder``       lock-order ranks: no rank inversions or cycles
- ``holdblock``       no blocking calls while an annotated lock is held
- ``slowlane``        compile-path tests carry the ``slow`` marker
"""

from __future__ import annotations

from pathlib import Path

from vlog_tpu_torch.analysis import (asyncblock, epochfence, holdblock,
                                     lockdiscipline, lockorder, meshshim,
                                     pallasshim, registry, slowlane,
                                     tracehop)
from vlog_tpu_torch.analysis.core import (Finding, Module, load_baseline,
                                          load_package, render_baseline)

__all__ = [
    "Finding", "Module", "PASSES", "load_baseline", "load_package",
    "render_baseline", "run_passes", "default_pkg_dir", "default_baseline",
]

PASSES = {m.RULE: m for m in (asyncblock, lockdiscipline, epochfence,
                              tracehop, registry, meshshim, pallasshim,
                              lockorder, holdblock, slowlane)}


def default_pkg_dir() -> Path:
    return Path(__file__).resolve().parents[1]


def default_baseline(pkg_dir: Path | None = None) -> Path:
    """The scanned package's own ``analysis/BASELINE.txt`` (for the port:
    ``vlog_tpu_torch/analysis/BASELINE.txt``; the JAX package's
    ``ANALYSIS_BASELINE.txt`` at the repo root is never read)."""
    return Path(pkg_dir or default_pkg_dir()) / "analysis" / "BASELINE.txt"


def run_passes(pkg_dir: Path | None = None,
               rules: list[str] | None = None,
               modules: list[Module] | None = None) -> list[Finding]:
    """Run the selected passes (all by default) over one parse of the
    package; findings sorted by location for stable output."""
    pkg_dir = Path(pkg_dir or default_pkg_dir())
    if modules is None:
        modules = load_package(pkg_dir)
    unknown = set(rules or ()) - PASSES.keys()
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(sorted(unknown))}")
    findings: list[Finding] = []
    for name, mod in PASSES.items():
        if rules and name not in rules:
            continue
        findings.extend(mod.run(modules, pkg_dir))
    return sorted(set(findings),
                  key=lambda f: (f.file, f.line, f.rule, f.message))
