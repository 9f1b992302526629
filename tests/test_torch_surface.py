"""The port does what the JAX package does, name by name.

For every module of ``vlog_tpu`` (read with ``ast``, never imported) the
port's namesake module must define every public top-level function and
class and every public method of those classes. Module pairs whose
names differ: ``backends/jax_backend`` -> ``torch_backend``,
``codecs/hevc/jax_core`` -> ``core``, ``ops/pallas_ladder`` ->
``fused_resize`` and ``native/avbuild`` -> ``native/build``; within
them ``JaxBackend`` is ``TorchBackend`` and ``resize_yuv420_pallas`` is
``fused_resize.resize_yuv420``. Every name a ``vlog_tpu`` package's
``__init__`` imports must be importable from the port's namesake
package.

The only names left out are :data:`LEFT_OUT`'s four groups, each with
its reason. An entry that the JAX package no longer defines, or that
the port has gained, fails too, so the list cannot go stale. Private
names (a leading ``_``) are out of scope.
"""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "vlog_tpu"

MODULE_PAIRS = {
    "backends/jax_backend.py": "backends/torch_backend.py",
    "codecs/hevc/jax_core.py": "codecs/hevc/core.py",
    "ops/pallas_ladder.py": "ops/fused_resize.py",
    "native/avbuild.py": "native/build.py",
}
NAME_PAIRS = {
    ("backends/jax_backend.py", "JaxBackend"): "TorchBackend",
    ("ops/pallas_ladder.py", "resize_yuv420_pallas"): "resize_yuv420",
}
# a module a JAX package __init__ imports, under its port name
INIT_PAIRS = {"jax_backend": "torch_backend"}

# reason -> {JAX module: names}; a class's methods go with the class
LEFT_OUT = {
    "a shim over JAX versions (check_rep / check_vma); the port's grid "
    "runs no shard_map": {
        "parallel/mesh.py": ("shard_map",),
    },
    "the Python entropy coders JAX runs under VLOG_NATIVE=0: the port's C "
    "coders are its only coders (no VLOG_NATIVE, no Python fallback), and "
    "the JAX tests hold those C coders to the Python ones": {
        "codecs/h264/cavlc.py": ("encode_residual_block", "SliceEncoder",
                                 "PSliceEncoder"),
        "codecs/h264/cabac_enc.py": ("zigzag", "H264Cabac",
                                     "CabacSliceCoder"),
    },
    "the VLOG_PALLAS switch, which the North star's device rule forbids: "
    "the kernel is the only resize on a CUDA tensor": {
        "ops/pallas_ladder.py": ("pallas_available", "use_pallas",
                                 "ladder_resize"),
    },
    "table generators that read the system libavcodec archive; the port "
    "ships their outputs (native/*.inc and the tables.py copies)": {
        "native/gen_tables.py": ("*",),
        "native/gen_aac_tables.py": ("*",),
        "native/gen_h264_cabac_tables.py": ("*",),
        "native/gen_hevc_tables.py": ("*",),
    },
}
_LEFT = {(mod, name) for group in LEFT_OUT.values()
         for mod, names in group.items() for name in names}
_LEFT_FILES = {mod for mod, name in _LEFT if name == "*"}

JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


def _public_names(path: Path) -> list[str]:
    """Public top-level functions and classes, and ``Class.method`` for
    every public method."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        names.append(node.name)
        if isinstance(node, ast.ClassDef):
            names += [f"{node.name}.{m.name}" for m in node.body
                      if isinstance(m, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                      and not m.name.startswith("_")]
    return names


def _port_module(rel: str) -> str:
    rel = MODULE_PAIRS.get(rel, rel)
    parts = rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["vlog_tpu_torch", *parts])


def _left_out(rel: str, name: str) -> bool:
    return (rel, name.split(".")[0]) in _LEFT


@pytest.mark.parametrize("rel", [m for m in JAX_MODULES
                                 if m not in _LEFT_FILES])
def test_port_defines_every_public_name(rel):
    mod = importlib.import_module(_port_module(rel))
    missing = []
    for name in _public_names(JAX_PKG / rel):
        if _left_out(rel, name):
            continue
        head, _, method = name.partition(".")
        obj = getattr(mod, NAME_PAIRS.get((rel, head), head), None)
        if obj is None or (method and not hasattr(obj, method)):
            missing.append(name)
    assert not missing, f"{_port_module(rel)} lacks {missing} of vlog_tpu/{rel}"


def _init_imports(path: Path) -> list[str]:
    return [a.asname or a.name
            for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom) and node.level == 0
            and node.module.split(".")[0] == "vlog_tpu"
            for a in node.names]


@pytest.mark.parametrize("rel", [m for m in JAX_MODULES
                                 if m.endswith("__init__.py")
                                 and _init_imports(JAX_PKG / m)])
def test_port_package_reexports_what_jax_imports(rel):
    pkg = _port_module(rel)
    missing = []
    for name in _init_imports(JAX_PKG / rel):
        try:
            exec(f"from {pkg} import {INIT_PAIRS.get(name, name)}", {})
        except ImportError:
            missing.append(name)
    assert not missing, f"{pkg} does not export {missing}"


def test_left_out_names_are_four_groups_that_stay_true():
    assert len(LEFT_OUT) == 4
    for rel, name in sorted(_LEFT):
        path = JAX_PKG / rel
        assert path.exists(), rel
        if name == "*":
            assert not (ROOT / "vlog_tpu_torch" / rel).exists(), rel
            continue
        assert name in _public_names(path), f"vlog_tpu/{rel} has no {name}"
        mod = importlib.import_module(_port_module(rel))
        assert not hasattr(mod, name), (
            f"{_port_module(rel)} now has {name}: take it off the list")


def test_every_module_pair_and_rename_is_real():
    for jax_rel, port_rel in MODULE_PAIRS.items():
        assert (JAX_PKG / jax_rel).exists(), jax_rel
        assert (ROOT / "vlog_tpu_torch" / port_rel).exists(), port_rel
        assert not (ROOT / "vlog_tpu_torch" / jax_rel).exists(), jax_rel
    for (rel, jax_name), port_name in NAME_PAIRS.items():
        assert jax_name in _public_names(JAX_PKG / rel)
        assert hasattr(importlib.import_module(_port_module(rel)), port_name)
