"""pallasshim: CUDA kernel code stays inside the port's kernel modules.

The port's counterpart of the JAX package's Pallas rule, aimed at the
port's own kernel surface. The kernel modules are ``ops/cuda_build.py``
(the one ``nvcc`` build of ``csrc/``) and one guarded wrapper a kernel:
``ops/fused_resize.py``, ``ops/motion_search.py`` and
``ops/h264_deblock.py``. Each wrapper owns
its ctypes load and launch counter, and launches its hand-written kernel
on a CUDA tensor while the plain PyTorch version serves a CPU tensor,
with no fallback from one to the other. Program builders call
:func:`~vlog_tpu_torch.ops.fused_resize.fused_resize_plane` (or the
resize helpers over it) and reach the motion search through
``codecs/hevc/core.py`` and the deblocking filter through
``codecs/h264/deblock.py``; they never see a kernel. A second route to the
card — a library's kernel built on the fly, a compiled graph of the
plain version, another loader of ``csrc/`` — would run kernel code past
those guards: it is not counted, not held to the plain version, and
silently forks the port's rule that every kernel is a hand-written one
behind one guarded wrapper.

Rule: outside the kernel modules, no module may

- import ``torch.utils.cpp_extension`` in any spelling
  (``import torch.utils.cpp_extension``, ``from torch.utils import
  cpp_extension``, ``from torch.utils.cpp_extension import load``) or
  reference that attribute path in code;
- import ``triton`` or any ``triton.*`` submodule;
- call or reference ``torch.compile`` (``from torch import compile``
  included);
- name the kernel sources or their compiler in a string literal: a
  ``csrc`` path component, a ``.cu``/``.cuh`` file, or ``nvcc``.
  Docstrings are prose, not code, and are not matched.

``native/build.py`` is not a kernel route and the rule lets it be: it
compiles the host C coders in ``native/`` (``*.c``) with the system C
compiler and loads them with ctypes — no ``csrc`` source, no ``nvcc``,
no device code — so none of the spellings above occur there. Should it
ever reach for ``csrc/`` or ``nvcc``, the literal rule fires on it like
on any other module.
"""

from __future__ import annotations

import ast
import re

from vlog_tpu_torch.analysis.core import Finding, Module, dotted_name

RULE = "pallasshim"

_KERNEL_MODULES = ("cuda_build.py", "fused_resize.py", "motion_search.py",
                   "h264_deblock.py")
_SHIM = ("ops/fused_resize.py, ops/motion_search.py, ops/h264_deblock.py or "
         "ops/cuda_build.py (the only sanctioned CUDA kernel surface)")
_CPP_EXT = "torch.utils.cpp_extension"
_KERNEL_LITERAL = re.compile(
    r"(^|[/\\])csrc([/\\]|$)|\.cuh?$|(^|[/\\])nvcc$")


def _exempt(mod: Module) -> bool:
    # The kernel modules themselves, and the analysis package (this file
    # quotes the banned spellings in docstrings/tests).
    parts = mod.pkg_parts
    return ((len(parts) == 2 and parts[0] == "ops"
             and parts[1] in _KERNEL_MODULES)
            or parts[0] == "analysis")


def _is_module(name: str | None, root: str) -> bool:
    return bool(name) and (name == root or name.startswith(root + "."))


def _import_findings(mod: Module) -> list[Finding]:
    findings = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _is_module(alias.name, _CPP_EXT) \
                        or _is_module(alias.name, "triton"):
                    findings.append(Finding(
                        RULE, mod.rel, node.lineno,
                        f"raw import {alias.name} — kernel code belongs "
                        f"in {_SHIM}"))
        elif isinstance(node, ast.ImportFrom):
            names = {alias.name for alias in node.names}
            if _is_module(node.module, _CPP_EXT) \
                    or _is_module(node.module, "triton"):
                findings.append(Finding(
                    RULE, mod.rel, node.lineno,
                    f"raw from {node.module} import — kernel code "
                    f"belongs in {_SHIM}"))
            elif node.module == "torch.utils" and "cpp_extension" in names:
                findings.append(Finding(
                    RULE, mod.rel, node.lineno,
                    f"raw from torch.utils import cpp_extension — kernel "
                    f"code belongs in {_SHIM}"))
            elif node.module == "torch" and "compile" in names:
                findings.append(Finding(
                    RULE, mod.rel, node.lineno,
                    f"raw from torch import compile — kernel code "
                    f"belongs in {_SHIM}"))
    return findings


def _docstrings(tree: ast.AST) -> set[int]:
    """ids of the docstring constants (module, class and function)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def _code_findings(mod: Module) -> list[Finding]:
    findings = []
    docs = _docstrings(mod.tree)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute):
            dotted = dotted_name(node)
            if dotted == "torch.compile":
                findings.append(Finding(
                    RULE, mod.rel, node.lineno,
                    f"torch.compile use — kernel code belongs in {_SHIM}"))
            elif dotted == _CPP_EXT:
                findings.append(Finding(
                    RULE, mod.rel, node.lineno,
                    f"raw {_CPP_EXT} attribute use — kernel code "
                    f"belongs in {_SHIM}"))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs \
                and _KERNEL_LITERAL.search(node.value.strip()):
            findings.append(Finding(
                RULE, mod.rel, node.lineno,
                f"kernel source or compiler named in a literal "
                f"({node.value.strip()!r}) — only {_SHIM} builds and "
                f"loads csrc/"))
    return findings


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if _exempt(mod):
            continue
        findings.extend(_import_findings(mod))
        findings.extend(_code_findings(mod))
    return findings
