"""registry: AST-extracted knob/metric/failpoint/span registries vs docs.

Five test suites grew five diverging regex copies of the same lint
("every knob parsed, every metric registered, every failpoint
documented"). This module is the single implementation: it AST-extracts
the real registries from source —

- **knobs**: ``VLOG_*`` names passed to ``config._env_*`` parsers or
  read via ``os.environ`` anywhere in the package (config.py plus the
  stragglers: worker/health.py, utils/failpoints.py);
- **failpoint sites**: the literal keys of ``SITES`` in
  ``utils/failpoints.py``;
- **metric families**: first-arg names of ``Counter``/``Gauge``/
  ``Histogram``/``Summary`` constructors in ``obs/metrics.py``
  (counters documented with their ``_total`` suffix), plus the
  hand-rendered ``# HELP``/``# TYPE`` families in the same file;
- **span names**: literal first args of ``span()``/``event()`` calls
  and literal ``name=`` kwargs of ``obs_store.record()`` calls across
  the package, the literal names of hot-path ``stage()`` spans
  (``<layer>.<step>``, dotted deeper where a step has parts), plus the
  synthesized ``stage.*`` names derived from ``STAGE_KEYS`` in
  obs/trace.py —

and checks both directions against the docs (README.md and
docs/DESIGN.md): everything extracted must be documented, and every
``VLOG_*`` token or failpoint-shaped backticked token in the docs must
exist in code (docs drift is a finding too).

The suites keep their per-plane declared lists as *coverage inputs*
via :func:`assert_knobs` / :func:`assert_metric_families` /
:func:`assert_failpoint_sites` / :func:`assert_documented` — a suite
asserting its plane's knobs still fails loudly if the plane's knob
was renamed, while the mechanics live here once.
"""

from __future__ import annotations

import ast
import re
from functools import lru_cache
from pathlib import Path
from typing import Iterable

from vlog_tpu_torch.analysis.core import (Finding, Module, dotted_name,
                                          load_package)

RULE = "registry"

_ENV_PARSERS = frozenset({"_env_str", "_env_int", "_env_float", "_env_bool",
                          "_env_path"})
_METRIC_CTORS = frozenset({"Counter", "Gauge", "Histogram", "Summary"})
_KNOB_RE = re.compile(r"VLOG_[A-Z][A-Z0-9_]*")
_HELP_RE = re.compile(r"#\s*(?:HELP|TYPE)\s+(vlog_\w+)")
_DOC_SITE_RE = re.compile(r"`([a-z]+\.[a-z_]+)`")


def _documented(name: str, docs: str) -> bool:
    """Whole-token docs presence: plain substring matching would let
    ``vlog_foo_reads`` pass on the strength of a documented
    ``vlog_foo_reads_total`` (and ``VLOG_TRACE`` on
    ``VLOG_TRACE_ENABLED``) — the token must not continue with an
    identifier character on either side."""
    return re.search(
        rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])",
        docs) is not None


def _last_seg(func: ast.AST) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _str_arg(call: ast.Call, pos: int = 0) -> str | None:
    if len(call.args) > pos and isinstance(call.args[pos], ast.Constant) \
            and isinstance(call.args[pos].value, str):
        return call.args[pos].value
    return None


def _str_kwarg(call: ast.Call, name: str) -> str | None:
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


# --------------------------------------------------------------------------
# Extraction
# --------------------------------------------------------------------------

def _str_constants(tree: ast.AST) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` assignments (failpoints.py reads
    its env var through the ``ENV_VAR`` constant, not a literal)."""
    consts: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = node.value.value
    return consts


def knob_parse_sites(modules: list[Module]) -> dict[str, str]:
    """``{knob: file}`` for every VLOG_* env var the package parses."""
    knobs: dict[str, str] = {}

    for mod in modules:
        consts = _str_constants(mod.tree)

        def _arg_str(node: ast.expr | None) -> str | None:
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                return node.value
            if isinstance(node, ast.Name):
                return consts.get(node.id)
            return None

        def _note(name: str | None) -> None:
            if name and _KNOB_RE.fullmatch(name):
                knobs.setdefault(name, mod.rel)

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                seg = _last_seg(node.func)
                arg = _arg_str(node.args[0]) if node.args else None
                if seg in _ENV_PARSERS:
                    _note(arg)
                elif seg in ("get", "getenv"):
                    recv = dotted_name(node.func.value) \
                        if isinstance(node.func, ast.Attribute) else None
                    if seg == "getenv" or (recv or "").endswith("environ"):
                        _note(arg)
            elif isinstance(node, ast.Subscript):
                recv = dotted_name(node.value)
                if (recv or "").endswith("environ") \
                        and isinstance(node.slice, ast.Constant):
                    _note(node.slice.value
                          if isinstance(node.slice.value, str) else None)
    return knobs


def failpoint_sites(modules: list[Module]) -> set[str]:
    """Literal keys of the SITES dict in utils/failpoints.py."""
    sites: set[str] = set()
    for mod in modules:
        if mod.pkg_parts[-1] != "failpoints.py":
            continue
        for node in ast.walk(mod.tree):
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if not any(isinstance(t, ast.Name) and t.id == "SITES"
                       for t in targets):
                continue
            if isinstance(value, ast.Dict):
                for key in value.keys:
                    if isinstance(key, ast.Constant) \
                            and isinstance(key.value, str):
                        sites.add(key.value)
    return sites


def metric_families(modules: list[Module]) -> set[str]:
    """Documented family names from obs/metrics.py (counters with the
    ``_total`` suffix prometheus appends, plus hand-rendered HELP/TYPE
    families in render())."""
    fams: set[str] = set()
    for mod in modules:
        if "/".join(mod.pkg_parts) != "obs/metrics.py":
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                seg = _last_seg(node.func)
                if seg in _METRIC_CTORS:
                    name = _str_arg(node)
                    if name:
                        # prometheus renders counters with a _total
                        # suffix whether or not the declared name
                        # carries one — normalize, don't double-append
                        if seg == "Counter" and not name.endswith("_total"):
                            name += "_total"
                        fams.add(name)
        fams.update(_HELP_RE.findall(mod.source))
    return fams


def span_names(modules: list[Module]) -> set[str]:
    """Literal span/marker names the package can emit."""
    names: set[str] = set()
    for mod in modules:
        if mod.pkg_parts[0] == "analysis":
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            seg = _last_seg(node.func)
            if seg in ("span", "event"):
                name = _str_arg(node)
                if name and re.fullmatch(r"[a-z]+\.[a-z_]+", name):
                    names.add(name)
            elif seg == "stage":
                name = _str_arg(node)
                if name and re.fullmatch(r"[a-z]+(\.[a-z_]+)+", name):
                    names.add(name)
            elif seg == "record":
                name = _str_kwarg(node, "name")
                if name and re.fullmatch(r"[a-z]+\.[a-z_]+", name):
                    names.add(name)
        # synthesized stage.* spans: derived from STAGE_KEYS in obs/trace.py
        if "/".join(mod.pkg_parts) == "obs/trace.py":
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Assign) \
                        and any(isinstance(t, ast.Name)
                                and t.id == "STAGE_KEYS"
                                for t in node.targets) \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) \
                                and isinstance(elt.value, str) \
                                and elt.value.endswith("_s"):
                            names.add(f"stage.{elt.value[:-2]}")
    return names


def docs_text(pkg_dir: Path) -> str:
    root = Path(pkg_dir).parent
    text = []
    for rel in ("README.md", "docs/DESIGN.md", "DESIGN.md"):
        p = root / rel
        if p.is_file():
            text.append(p.read_text())
    return "\n".join(text)


def _aux_sources(pkg_dir: Path) -> str:
    """Test/bench sources outside the package: a knob only they parse
    (VLOG_TEST_PG_DSN, bench budget knobs) is documented-and-real, not
    docs drift."""
    root = Path(pkg_dir).parent
    chunks = []
    tests = root / "tests"
    if tests.is_dir():
        for p in sorted(tests.rglob("*.py")):
            if "__pycache__" not in p.parts:
                chunks.append(p.read_text())
    for name in ("bench.py", "quality_bench.py"):
        p = root / name
        if p.is_file():
            chunks.append(p.read_text())
    return "\n".join(chunks)


# --------------------------------------------------------------------------
# The pass
# --------------------------------------------------------------------------

def run(modules: list[Module], pkg_dir) -> list[Finding]:
    findings: list[Finding] = []
    docs = docs_text(pkg_dir)
    doc_file = "README.md"

    knobs = knob_parse_sites(modules)
    for knob, where in sorted(knobs.items()):
        if not _documented(knob, docs):
            findings.append(Finding(
                RULE, where, 0,
                f"knob {knob} parsed but undocumented in README/DESIGN"))
    aux = _aux_sources(pkg_dir)
    for knob in sorted(set(_KNOB_RE.findall(docs)) - knobs.keys()):
        if knob not in aux:
            findings.append(Finding(
                RULE, doc_file, 0,
                f"docs mention {knob} but nothing in the package parses it"))

    fp_rel = next((m.rel for m in modules
                   if m.pkg_parts[-1] == "failpoints.py"), doc_file)
    met_rel = next((m.rel for m in modules
                    if "/".join(m.pkg_parts) == "obs/metrics.py"), doc_file)
    sites = failpoint_sites(modules)
    for site in sorted(sites):
        if f"`{site}`" not in docs:
            findings.append(Finding(
                RULE, fp_rel, 0,
                f"failpoint site {site} registered but undocumented"))
    families = {s.split(".", 1)[0] for s in sites}
    spans = span_names(modules)
    for token in sorted(set(_DOC_SITE_RE.findall(docs))):
        if token.split(".", 1)[0] in families \
                and token not in sites and token not in spans:
            findings.append(Finding(
                RULE, doc_file, 0,
                f"docs document failpoint-shaped `{token}` but no such "
                f"site is registered"))

    for fam in sorted(metric_families(modules)):
        if not _documented(fam, docs):
            findings.append(Finding(
                RULE, met_rel, 0,
                f"metric family {fam} registered but undocumented"))

    for name in sorted(spans):
        if not _documented(name, docs):
            findings.append(Finding(
                RULE, doc_file, 0,
                f"span name {name} emitted but undocumented"))
    return findings


# --------------------------------------------------------------------------
# Library API for the per-plane test suites (declared-coverage inputs)
# --------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _repo() -> tuple[tuple[Module, ...], str]:
    pkg_dir = Path(__file__).resolve().parents[1]
    return tuple(load_package(pkg_dir)), docs_text(pkg_dir)


def repo_modules() -> list[Module]:
    """This checkout's parsed package (cached) — for suites that want
    to run the extractors over the real tree."""
    return list(_repo()[0])


def _fail(problems: list[str]) -> None:
    if problems:
        raise AssertionError("; ".join(problems))


def assert_knobs(knobs: Iterable[str]) -> None:
    """Each declared knob is parsed somewhere in the package AND
    documented — the suites' drop-in for the old regex lints."""
    modules, docs = _repo()
    parsed = knob_parse_sites(list(modules))
    problems = []
    for knob in knobs:
        if knob not in parsed:
            problems.append(f"{knob} not parsed anywhere in vlog_tpu_torch")
        if not _documented(knob, docs):
            problems.append(f"{knob} missing from README/DESIGN")
    _fail(problems)


def assert_failpoint_sites(sites: Iterable[str]) -> None:
    modules, docs = _repo()
    registered = failpoint_sites(list(modules))
    problems = []
    for site in sites:
        if site not in registered:
            problems.append(f"failpoint {site} not in failpoints.SITES")
        if f"`{site}`" not in docs:
            problems.append(f"failpoint {site} missing from README/DESIGN")
    _fail(problems)


def _live_family_names() -> set[str] | None:
    """Family names actually reachable at scrape time (a fresh HTTP-app
    registry + the process runtime registry), or None without
    prometheus-client. Static extraction alone would keep passing on a
    constructor stranded in dead code."""
    from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS, Metrics, runtime

    if not HAVE_PROMETHEUS:
        return None
    names: set[str] = set()
    for reg in (Metrics().registry, runtime().registry):
        for fam in reg.collect():
            names.add(fam.name + ("_total" if fam.type == "counter" else ""))
    return names


def assert_metric_families(names: Iterable[str]) -> None:
    modules, docs = _repo()
    registered = metric_families(list(modules))
    # hand-rendered HELP/TYPE families (Metrics.render) are live through
    # render(), not through registry.collect()
    manual: set[str] = set()
    for mod in modules:
        if "/".join(mod.pkg_parts) == "obs/metrics.py":
            manual.update(_HELP_RE.findall(mod.source))
    live = _live_family_names()
    problems = []
    for name in names:
        if name not in registered:
            problems.append(f"metric {name} not registered in obs/metrics.py")
        if not _documented(name, docs):
            problems.append(f"metric {name} missing from README/DESIGN")
        if live is not None and name not in live and name not in manual:
            problems.append(f"metric {name} not live in any registry "
                            f"(constructor exists but never runs?)")
    _fail(problems)


def assert_span_names(names: Iterable[str]) -> None:
    modules, docs = _repo()
    emitted = span_names(list(modules))
    problems = []
    for name in names:
        if name not in emitted:
            problems.append(f"span {name} never emitted in vlog_tpu_torch")
        if not _documented(name, docs):
            problems.append(f"span {name} missing from README/DESIGN")
    _fail(problems)


def assert_documented(tokens: Iterable[str], *, backticked: bool = False
                      ) -> None:
    """Docs-presence only (span attrs, headers — things with no single
    code registry to extract)."""
    _, docs = _repo()
    problems = []
    for tok in tokens:
        ok = (f"`{tok}`" in docs) if backticked else _documented(tok, docs)
        if not ok:
            problems.append(f"{tok} missing from README/DESIGN")
    _fail(problems)
