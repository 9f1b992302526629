"""The port's static-analysis passes (``vlog_tpu_torch/analysis/``)
against the JAX package's, and the port's own gate over its tree.

Every fixture test of ``tests/test_analysis.py`` runs here once more with
that module's ``run_passes`` swapped for a parity runner: the fixture
package goes through the reference's passes and, as a copy in which
``vlog_tpu.`` reads ``vlog_tpu_torch.`` (the tracehop rule keys on the
package's own tracer), through the port's; the two ``(rule, file, line,
message)`` lists must be equal, and the reference test's own assertions
then run on the port's findings. The baseline/CLI tests of that module
run against the port's CLI and baseline functions. The two retargeted
passes (``pallasshim``: CUDA kernel code stays in ``ops/fused_resize.py``;
``meshshim``: device probes go through ``device.py`` and
``parallel/mesh.py``) get fixtures of their own, positive and negative.
"""

from __future__ import annotations

import shutil
import textwrap
from functools import lru_cache
from pathlib import Path

import pytest

import tests.test_analysis as ref_tests
from vlog_tpu.analysis import run_passes as jax_run_passes
from vlog_tpu_torch import analysis as tan
from vlog_tpu_torch.analysis import core as tcore
from vlog_tpu_torch.analysis.__main__ import main as port_cli
from vlog_tpu_torch.analysis.lockorder import build_table

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "vlog_tpu_torch"


def _tuples(findings) -> list[tuple]:
    return [(f.rule, f.file, f.line, f.message) for f in findings]


def _port_copy(pkg_dir: Path) -> Path:
    """The fixture tree (the package and the docs/tests beside it) copied
    under ``<parent>/_port/`` with ``vlog_tpu.`` spelled
    ``vlog_tpu_torch.`` in its sources; the package keeps its name, so
    findings' paths agree."""
    src_root = pkg_dir.parent
    dst_root = src_root / "_port"
    if dst_root.exists():
        shutil.rmtree(dst_root)
    dst_root.mkdir()
    for p in src_root.rglob("*"):
        rel = p.relative_to(src_root)
        if rel.parts[0] == "_port" or not p.is_file() \
                or "__pycache__" in rel.parts:
            continue
        out = dst_root / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        text = p.read_text()
        if p.suffix == ".py":
            text = text.replace("vlog_tpu.", "vlog_tpu_torch.")
        out.write_text(text)
    return dst_root / pkg_dir.name


def _parity_run_passes(pkg_dir=None, rules=None, modules=None):
    assert pkg_dir is not None and modules is None
    pkg_dir = Path(pkg_dir)
    want = jax_run_passes(pkg_dir, rules=rules)
    got = tan.run_passes(_port_copy(pkg_dir), rules=rules)
    assert _tuples(got) == _tuples(want)
    return got


# (class, method) of every fixture test in tests/test_analysis.py whose
# rule the port carries over unchanged (meshshim and pallasshim are
# retargeted: their fixtures are below)
FIXTURE_CASES = [
    ("TestAsyncBlock", "test_blocking_calls_in_async_handlers_fire"),
    ("TestAsyncBlock", "test_sync_scopes_and_to_thread_are_clean"),
    ("TestAsyncBlock", "test_only_serving_packages_in_scope"),
    ("TestAsyncBlock", "test_worker_package_in_scope"),
    ("TestLockDiscipline",
     "test_lock_free_access_fires_and_disciplined_forms_pass"),
    ("TestLockDiscipline", "test_annotation_parse_edge_cases"),
    ("TestLockDiscipline", "test_deferred_bodies_get_no_lock_credit"),
    ("TestLockDiscipline", "test_with_lock_covers_nested_and_locked_suffix"),
    ("TestLockOrder", "test_rank_inversion_fires"),
    ("TestLockOrder",
     "test_cycle_between_unranked_guarded_by_locks_fires"),
    ("TestLockOrder",
     "test_agreement_lint_missing_rank_in_annotated_module"),
    ("TestLockOrder", "test_agreement_lint_dangling_and_duplicate_ranks"),
    ("TestLockOrder", "test_guarded_by_naming_missing_lock_fires"),
    ("TestLockOrder", "test_disciplined_module_is_clean"),
    ("TestHoldBlock", "test_blocking_ops_under_lock_fire"),
    ("TestHoldBlock", "test_holds_ok_escape_needs_a_reason"),
    ("TestHoldBlock", "test_wait_on_own_condition_clean_foreign_wait_fires"),
    ("TestHoldBlock", "test_blocking_outside_lock_is_clean"),
    ("TestEpochFence", "test_unfenced_claim_gated_route_fires"),
    ("TestTraceHop", "test_uncaptured_hop_in_traced_module_fires"),
    ("TestTraceHop", "test_untraced_module_out_of_scope"),
    ("TestRegistry", "test_agreement_holds_when_docs_cover_everything"),
    ("TestRegistry", "test_each_omission_and_drift_direction_fires"),
    ("TestRegistry", "test_counter_total_suffix_not_doubled"),
]

CLI_CASES = [
    "test_baseline_suppresses_exactly_its_findings",
    "test_cli_fails_on_fresh_finding_and_update_writes",
    "test_rule_restricted_update_keeps_other_rules_entries",
    "test_comments_and_blanks_ignored_in_baseline",
]


def test_fixture_list_covers_the_reference_module():
    """Every fixture test of tests/test_analysis.py is either run here
    for parity or belongs to a retargeted rule / a real-repo check."""
    retargeted_or_repo = {
        ("TestMeshShim", "test_every_raw_spelling_fires"),
        ("TestMeshShim", "test_shim_module_and_shim_users_are_clean"),
        ("TestMeshShim", "test_real_repo_is_clean"),
        ("TestLockOrder", "test_real_repo_lock_order_is_clean"),
        ("TestHoldBlock", "test_real_repo_holdblock_is_clean"),
        ("TestEpochFence", "test_real_worker_api_is_fully_fenced"),
        ("TestRegistry", "test_library_asserts_cover_declared_lists"),
    }
    seen = set()
    for cls_name in dir(ref_tests):
        cls = getattr(ref_tests, cls_name)
        if not (isinstance(cls, type) and cls_name.startswith("Test")):
            continue
        for name in dir(cls):
            if name.startswith("test_"):
                seen.add((cls_name, name))
    cli = {("TestBaselineAndCli", n) for n in CLI_CASES}
    assert seen == set(FIXTURE_CASES) | retargeted_or_repo | cli


@pytest.mark.parametrize("case", FIXTURE_CASES, ids=lambda c: f"{c[0]}.{c[1]}")
def test_reference_fixture_gives_equal_findings(case, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_tests, "run_passes", _parity_run_passes)
    cls_name, method = case
    getattr(getattr(ref_tests, cls_name)(), method)(tmp_path)


@pytest.mark.parametrize("method", CLI_CASES)
def test_reference_cli_cases_hold_for_the_port(method, tmp_path,
                                               monkeypatch):
    """The reference's baseline/CLI tests, with its CLI, passes and
    baseline functions replaced by the port's."""
    for name, fn in (("cli_main", port_cli), ("run_passes", tan.run_passes),
                     ("render_baseline", tan.render_baseline),
                     ("load_baseline", tan.load_baseline)):
        monkeypatch.setattr(ref_tests, name, fn)
    case = ref_tests.TestBaselineAndCli()
    getattr(case, method)(tmp_path)


def test_cli_exit_codes_and_baselines_equal(tmp_path, capsys):
    """Both CLIs on one violating fixture: the same exit codes at each
    step, the same baseline entries written, the same usage error."""
    from vlog_tpu.analysis.__main__ import main as jax_cli

    pkg = ref_tests._pkg(tmp_path, {"api/h.py": """\
        import time

        async def handler():
            time.sleep(1)
    """})
    codes = {}
    entries = {}
    for name, cli, load in (("jax", jax_cli, ref_tests.load_baseline),
                            ("port", port_cli, tan.load_baseline)):
        bl = tmp_path / f"{name}.txt"
        steps = [
            cli(["--root", str(pkg), "--baseline", str(bl)]),
            cli(["--root", str(pkg), "--rule", "asyncblock",
                 "--baseline", str(bl)]),
            cli(["--root", str(pkg), "--baseline", str(bl),
                 "--baseline-update"]),
            cli(["--root", str(pkg), "--baseline", str(bl)]),
            cli(["--root", str(pkg), "--rule", "nosuchrule",
                 "--baseline", str(bl)]),
        ]
        codes[name] = steps
        entries[name] = load(bl)
    capsys.readouterr()
    assert codes["port"] == codes["jax"] == [1, 1, 0, 0, 2]
    assert entries["port"] == entries["jax"]
    assert len(entries["port"]) == 1


# --------------------------------------------------------------------------
# slowlane over the repo's tests/ (and a fixture test tree)
# --------------------------------------------------------------------------

def test_slowlane_over_the_repo_tests_equals_the_reference():
    want = jax_run_passes(ROOT / "vlog_tpu", rules=["slowlane"])
    got = tan.run_passes(PORT_DIR, rules=["slowlane"])
    assert _tuples(got) == _tuples(want)


def test_slowlane_fixture_tree_equal_findings(tmp_path):
    pkg = ref_tests._pkg(tmp_path, {"__init__.py": ""})
    tests_dir = tmp_path / "tests"
    tests_dir.mkdir()
    (tests_dir / "test_fast.py").write_text(textwrap.dedent("""\
        import pytest
        from pkg.parallel import ladder_encode_program, AsrEngine

        def test_compiles_in_the_fast_lane():
            ladder_encode_program(None)          # finding

        @pytest.mark.slow
        def test_marked_slow():
            ladder_encode_program(None)

        def test_escaped():
            AsrEngine(None)    # slowlane-ok: tiny checkpoint

        @pytest.mark.parametrize("x", [pytest.param(1, marks=pytest.mark.slow)])
        def test_param_marked(x):
            hevc_chain_program(x)

        def test_two_triggers():
            hevc_chain_ladder(None)               # finding
            get_engine()                          # finding
    """))
    (tests_dir / "test_module_slow.py").write_text(textwrap.dedent("""\
        import pytest
        pytestmark = pytest.mark.slow

        def test_anything():
            get_engine()
    """))
    (tests_dir / "test_module_ok.py").write_text(textwrap.dedent("""\
        # slowlane-ok(module): every engine here is a stub

        def test_anything():
            get_engine()
    """))
    got = _parity_run_passes(pkg, rules=["slowlane"])
    assert [(f.file, f.line) for f in got] == [
        ("tests/test_fast.py", 5), ("tests/test_fast.py", 19),
        ("tests/test_fast.py", 20)]


# --------------------------------------------------------------------------
# pallasshim, retargeted: CUDA kernel code stays in ops/fused_resize.py
# --------------------------------------------------------------------------

class TestPallasShimPort:
    def test_every_kernel_route_fires(self, tmp_path):
        pkg = ref_tests._pkg(tmp_path, {"worker/rogue.py": """\
            import torch
            import torch.utils.cpp_extension
            import triton
            import triton.language as tl
            from torch.utils import cpp_extension
            from torch.utils.cpp_extension import load_inline
            from triton import jit
            from torch import compile

            SRC = "csrc/other_kernel.cu"

            def build():
                return torch.utils.cpp_extension.load("k", [SRC])

            def fast(fn):
                return torch.compile(fn)

            def compiler():
                return ["nvcc", "-O3"]
        """})
        found = tan.run_passes(pkg, rules=["pallasshim"])
        lines = sorted(f.line for f in found)
        assert lines == [2, 3, 4, 5, 6, 7, 8, 10, 13, 16, 19]
        assert all("ops/fused_resize.py" in f.message for f in found)

    def test_shim_module_and_host_builds_are_clean(self, tmp_path):
        pkg = ref_tests._pkg(tmp_path, {
            # the kernel module itself builds and loads csrc/
            "ops/fused_resize.py": """\
                import ctypes
                import subprocess
                from pathlib import Path

                _SOURCE = Path(__file__).parent.parent / "csrc" / "k.cu"

                def build():
                    subprocess.run(["nvcc", "-o", "k.so", str(_SOURCE)])
                    return ctypes.CDLL("k.so")
            """,
            # host C coders: cc + ctypes, no csrc, no nvcc
            "native/build.py": '''\
                """Builds the host coders; never csrc/ or nvcc."""
                import ctypes
                import subprocess

                def build():
                    subprocess.run(["cc", "-O2", "-shared", "-o", "c.so",
                                    "coder.c"])
                    return ctypes.CDLL("c.so")
            ''',
            # callers go through the wrapper; a local .compile is not torch's
            "parallel/ladder.py": '''\
                """Calls fused_resize_plane (csrc/fused_resize.cu)."""
                from pkg.ops.fused_resize import build

                def program(pattern):
                    return pattern.compile("x") and build
            ''',
        })
        assert tan.run_passes(pkg, rules=["pallasshim"]) == []

    def test_real_port_is_clean(self):
        assert [f for f in _port_findings() if f.rule == "pallasshim"] == []


# --------------------------------------------------------------------------
# meshshim, retargeted: device probes go through device.py / parallel/mesh
# --------------------------------------------------------------------------

class TestMeshShimPort:
    def test_every_raw_probe_fires(self, tmp_path):
        pkg = ref_tests._pkg(tmp_path, {"worker/rogue.py": """\
            import torch
            from torch import cuda
            from torch.cuda import device_count, is_available

            def pick():
                if torch.cuda.is_available():
                    return torch.device("cuda")
                return torch.device("cpu")

            def cards():
                return range(torch.cuda.device_count())

            def aliased():
                return cuda.is_available()

            def lazy():
                n = torch.cuda.device_count()  # meshshim-ok:
                return n
        """})
        found = tan.run_passes(pkg, rules=["meshshim"])
        assert sorted(f.line for f in found) == [3, 3, 6, 11, 14, 17]
        assert any("without a justification" in f.message for f in found)
        assert all(f.rule == "meshshim" for f in found)

    def test_surfaces_and_justified_escapes_are_clean(self, tmp_path):
        pkg = ref_tests._pkg(tmp_path, {
            "device.py": """\
                import torch

                def resolve_device(device="cuda"):
                    if not torch.cuda.is_available():
                        raise RuntimeError("no CUDA")
                    return torch.device(device)
            """,
            "parallel/mesh.py": """\
                import torch

                def visible_cuda_devices():
                    return [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
            """,
            "obs/profiler.py": """\
                import torch

                def activities():
                    if torch.cuda.is_available():  # meshshim-ok: which activities to trace
                        return ["cpu", "cuda"]
                    return ["cpu"]
            """,
            "parallel/scheduler.py": """\
                from pkg.parallel.mesh import visible_cuda_devices

                def devices():
                    return visible_cuda_devices()

                def initialized(torch):
                    return torch.cuda.is_initialized()
            """,
        })
        assert tan.run_passes(pkg, rules=["meshshim"]) == []

    def test_real_port_is_clean(self):
        assert [f for f in _port_findings() if f.rule == "meshshim"] == []


# --------------------------------------------------------------------------
# The port's tree: the gate, its baseline, its ranks and routes
# --------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _port_findings_cached() -> tuple:
    return tuple(tan.run_passes())


def _port_findings() -> list:
    return list(_port_findings_cached())


def test_port_is_clean_against_its_baseline():
    findings = _port_findings()
    known = tan.load_baseline(tan.default_baseline())
    fresh = [f for f in findings if f.key not in known]
    assert not fresh, "non-baselined static-analysis findings:\n" + \
        "\n".join(f.render() for f in fresh)
    assert not known - {f.key for f in findings}, "stale baseline entries"


def test_cli_gate_exits_zero_on_the_port(capsys):
    assert port_cli([]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s) (2 baselined, 0 stale" in out


_BASELINED = ("TPU_" + "ENABLED", "VIDEO_" + "CODEC")


def test_port_baseline_holds_only_the_two_justified_knobs():
    path = tan.default_baseline()
    assert path == PORT_DIR / "analysis" / "BASELINE.txt"
    assert path != ROOT / "ANALYSIS_BASELINE.txt"
    lines = path.read_text().splitlines()
    entries = [(i, tcore.parse_entry(ln)) for i, ln in enumerate(lines)
               if tcore.parse_entry(ln) is not None]
    # the knob names are spelled in two pieces: the registry pass counts
    # a knob named anywhere under tests/ as parsed there, which would
    # hide the very findings this baseline grandfathers
    assert {e[2] for _, e in entries} == {
        f"docs mention VLOG_{k} but nothing in the package parses it"
        for k in _BASELINED}
    for i, _ in entries:
        # a justification comment directly above every entry
        assert lines[i - 1].startswith("# "), lines[i - 1]


def test_every_pass_ran_over_the_parsed_port():
    mods = tcore.load_package(PORT_DIR)
    rels = {m.rel for m in mods}
    for rel in ("api/worker_api.py", "parallel/scheduler.py",
                "delivery/plane.py", "worker/brownout.py",
                "ops/fused_resize.py", "device.py", "parallel/mesh.py"):
        assert f"vlog_tpu_torch/{rel}" in rels
    assert set(tan.PASSES) == {"asyncblock", "lockdiscipline", "epochfence",
                               "tracehop", "registry", "meshshim",
                               "pallasshim", "lockorder", "holdblock",
                               "slowlane"}


@pytest.mark.parametrize("rule", ["lockorder", "holdblock", "lockdiscipline",
                                  "epochfence", "asyncblock", "tracehop"])
def test_port_rule_clean(rule):
    assert [f for f in _port_findings() if f.rule == rule] == []


def _rank_table(pkg_dir: Path) -> dict:
    from vlog_tpu.analysis.core import load_package as jax_load
    from vlog_tpu.analysis.lockorder import build_table as jax_table

    if pkg_dir.name == "vlog_tpu":
        table, _ = jax_table(jax_load(pkg_dir))
    else:
        table, _ = build_table(tcore.load_package(pkg_dir))
    out = {}
    for rel, locks in table.items():
        for field, info in locks.items():
            if info.rank is not None:
                out[(rel.split("/", 1)[1], field)] = info.rank
    return out


def test_port_keeps_every_reference_rank():
    """Every instance lock the reference ranks carries the same rank on
    the same field of the same module in the port."""
    want = _rank_table(ROOT / "vlog_tpu")
    got = _rank_table(PORT_DIR)
    assert {k: got.get(k) for k in want} == want
    # the port's own locks: the admin app's thumbnailer, the ASR pool
    assert {k: v for k, v in got.items() if k not in want} == {
        ("api/catalog.py", "_lock"): 5, ("asr/decode.py", "_lock"): 24}


def test_readme_lists_every_port_rank():
    readme = (ROOT / "README.md").read_text()
    start = readme.index("## PyTorch/CUDA port (`vlog_tpu_torch`)")
    section = readme[start:readme.index("\n## ", start + 1)]
    for (rel, field), rank in _rank_table(PORT_DIR).items():
        assert f"| {rank} | `{rel}:{field}` |" in section, (rel, field)


def _write_routes(path: Path) -> list[tuple[str, str]]:
    import ast

    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr.startswith("add_") and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.append((node.func.attr, node.args[0].value))
    return sorted(out)


def test_worker_api_registers_the_reference_routes():
    """epochfence's subject: the port's Worker API registers the same
    routes as the reference's (19), so a clean pass covers the same
    claim-gated writes."""
    want = _write_routes(ROOT / "vlog_tpu" / "api" / "worker_api.py")
    got = _write_routes(PORT_DIR / "api" / "worker_api.py")
    assert got == want
    assert len(got) == 19


def test_registry_library_asserts_cover_declared_lists():
    from vlog_tpu_torch.analysis import registry as reg

    reg.assert_knobs(("VLOG_PIPELINE_DEPTH", "VLOG_MESH_SLOTS",
                      "VLOG_BENCHTREND_TOL", "VLOG_LOCK_PROBE_INTERVAL_S"))
    reg.assert_failpoint_sites(("delivery.read", "device.fault"))
    reg.assert_metric_families(("vlog_mesh_slots",
                                "vlog_delivery_requests_total",
                                "vlog_lock_wait_seconds",
                                "vlog_lock_hold_seconds"))
    reg.assert_span_names(("worker.transcode", "queue.wait"))
    reg.assert_documented(("mesh.slot",), backticked=True)
    with pytest.raises(AssertionError, match="VLOG_NOT_A_KNOB"):
        reg.assert_knobs(("VLOG_NOT_A_KNOB",))
    with pytest.raises(AssertionError, match="not.a.site"):
        reg.assert_failpoint_sites(("not.a.site",))


def test_registry_extractors_agree_with_the_reference_on_shared_surfaces():
    """The knobs and failpoint sites both packages register: the port
    parses every knob the reference parses except the two it baselines
    and the reference's two kernel switches (``VLOG_NATIVE``: the C
    coders' Python fallback, ``VLOG_PALLAS``: the Pallas plane; the port
    has neither), and registers every failpoint site the reference
    does."""
    from vlog_tpu.analysis import registry as jreg
    from vlog_tpu.analysis.core import load_package as jax_load
    from vlog_tpu_torch.analysis import registry as treg

    jmods = jax_load(ROOT / "vlog_tpu")
    tmods = tcore.load_package(PORT_DIR)
    jknobs = set(jreg.knob_parse_sites(jmods))
    tknobs = set(treg.knob_parse_sites(tmods))
    assert jknobs - tknobs == {f"VLOG_{k}" for k in _BASELINED} | {
        "VLOG_NATIVE", "VLOG_PALLAS"}
    assert jreg.failpoint_sites(jmods) <= treg.failpoint_sites(tmods)
    assert {"vlog_lock_wait_seconds", "vlog_lock_hold_seconds"} <= \
        treg.metric_families(tmods)
