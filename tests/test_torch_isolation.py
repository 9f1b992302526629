"""The PyTorch port stands alone: no module of ``vlog_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``vlog_tpu``, nor
``httpx`` (the port's one HTTP library is ``aiohttp``).

Checked twice: by importing every port module (and chip_smoke) in a
subprocess whose ``sys.meta_path`` refuses jax/jaxlib/vlog_tpu/httpx,
and by reading every import statement in their sources. The walk covers
the HTTP plane's modules (the Worker API server, auth, the remote
worker, the SLO plane, the GC) and the serving plane's (the Postgres
facade and its wire-protocol double, the delivery plane, the public API
and its UI) and the multi-device grid's (the mesh, the ladder grids and
the dry run) and the admin plane's (the admin API, the catalog, the audit
log, the sessions, chapters and codec strings, the console client) and
the AV1 path's (the OBU parser, the delegated encode) and the tooling's
(the analysis passes, the lock witness, the bench-trend gate). Under the
same block the subprocess loads every name the port's package
``__init__`` files re-export (``parallel``'s resolve at first use) and
the library functions that mirror the JAX package's
(``H264Encoder.encode``, the resize API, the colour conversions,
``single_chip_ladder``, the fMP4 and failpoint helpers).
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "vlog_tpu_torch"
BLOCKED = ("jax", "jaxlib", "vlog_tpu", "httpx")
HTTP_PLANE = ("vlog_tpu_torch.api.worker_api", "vlog_tpu_torch.api.auth",
              "vlog_tpu_torch.api.errors", "vlog_tpu_torch.worker.remote",
              "vlog_tpu_torch.obs.slo", "vlog_tpu_torch.storage.gc",
              # the serving plane and the Postgres facade
              "vlog_tpu_torch.db.pg", "vlog_tpu_torch.db.pgfake",
              "vlog_tpu_torch.delivery", "vlog_tpu_torch.delivery.cache",
              "vlog_tpu_torch.delivery.gossip", "vlog_tpu_torch.delivery.http",
              "vlog_tpu_torch.delivery.l2", "vlog_tpu_torch.delivery.plane",
              "vlog_tpu_torch.delivery.ring", "vlog_tpu_torch.api.public_api",
              "vlog_tpu_torch.api.pagination", "vlog_tpu_torch.web",
              # the (data x rung) grid and its dry run
              "vlog_tpu_torch.parallel.mesh", "vlog_tpu_torch.parallel.ladder",
              "vlog_tpu_torch.parallel.hevc_ladder",
              "vlog_tpu_torch.parallel.dryrun",
              # the admin plane and its console client
              "vlog_tpu_torch.api.admin_api", "vlog_tpu_torch.api.catalog",
              "vlog_tpu_torch.api.audit", "vlog_tpu_torch.jobs.sessions",
              "vlog_tpu_torch.media.chapters", "vlog_tpu_torch.media.codecstr",
              "vlog_tpu_torch.cli", "vlog_tpu_torch.cli.main",
              # the AV1 re-encode
              "vlog_tpu_torch.codecs.av1", "vlog_tpu_torch.backends.av1_path",
              # the tooling over the sources: the analysis passes, the
              # lock witness and the bench-trend gate
              "vlog_tpu_torch.analysis", "vlog_tpu_torch.analysis.__main__",
              "vlog_tpu_torch.analysis.core",
              "vlog_tpu_torch.analysis.asyncblock",
              "vlog_tpu_torch.analysis.epochfence",
              "vlog_tpu_torch.analysis.holdblock",
              "vlog_tpu_torch.analysis.lockdiscipline",
              "vlog_tpu_torch.analysis.lockorder",
              "vlog_tpu_torch.analysis.meshshim",
              "vlog_tpu_torch.analysis.pallasshim",
              "vlog_tpu_torch.analysis.registry",
              "vlog_tpu_torch.analysis.slowlane",
              "vlog_tpu_torch.analysis.tracehop",
              "vlog_tpu_torch.utils.locktrace",
              "vlog_tpu_torch.obs.benchtrend")
# names each package's __init__ re-exports, and the library functions
# that mirror the JAX package's: loaded with jax and vlog_tpu blocked
REEXPORTS = (
    ("vlog_tpu_torch.ops", ("rgb_to_yuv420", "yuv420_to_rgb",
                            "yuv420_to_yuv444", "yuv444_to_yuv420",
                            "resize_plane", "resize_yuv420",
                            "ladder_resize_yuv420", "transform")),
    ("vlog_tpu_torch.parallel", (
        "LaggedRateControl", "PipelineExecutor", "StagedBatch", "MeshShape",
        "MeshSpec", "RungGrid", "balanced_rung_columns", "make_mesh",
        "parse_mesh_spec", "resolve_mesh_shape", "rung_grid",
        "shard_frames", "MeshScheduler", "SlotLease", "SlotTicket",
        "current_lease", "get_scheduler", "grid_for_run",
        "host_pool_for_run", "mesh_for_run", "ladder_local",
        "ladder_matrices", "sharded_ladder_levels", "sharded_ladder_step",
        "single_chip_ladder")),
    ("vlog_tpu_torch.codecs.h264", ("NalUnit", "make_sps", "make_pps",
                                    "annexb", "avcc_config")),
    ("vlog_tpu_torch.backends", ("FrameSource", "Mp4H264FrameSource",
                                 "UnsupportedSource", "Y4mFrameSource",
                                 "open_source", "torch_backend")),
    ("vlog_tpu_torch.asr", ("log_mel_spectrogram",)),
    ("vlog_tpu_torch.utils", ("atomic_write_bytes", "atomic_write_text")),
    ("vlog_tpu_torch.codecs.h264.api", ("H264Encoder",)),
    ("vlog_tpu_torch.codecs.h264.encoder", ("encode_gop", "pad_to_mb",
                                            "frame_levels")),
    ("vlog_tpu_torch.codecs.h264.inter", ("p_frame_levels",)),
    ("vlog_tpu_torch.codecs.h264.cavlc", ("zigzag",)),
    ("vlog_tpu_torch.codecs.hevc.core", ("encode_batch_dsp",)),
    ("vlog_tpu_torch.media.fmp4", ("avcc_config", "raw_sample_entry")),
    ("vlog_tpu_torch.utils.failpoints", ("disarm", "arm_from_env")),
)

_BLOCKED_IMPORT_SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {root!r})
    import vlog_tpu_torch
    names = ["vlog_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(vlog_tpu_torch.__path__,
                                              "vlog_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    for pkg, attrs in {reexports!r}:
        mod = importlib.import_module(pkg)
        missing = [a for a in attrs if getattr(mod, a, None) is None]
        assert not missing, (pkg, missing)
    assert callable(sys.modules["vlog_tpu_torch.codecs.h264.api"]
                    .H264Encoder.encode)
    import chip_smoke
    leaked = [m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not leaked, leaked
    assert not set({http_plane!r}) - set(names), names
    print(len(names))
""")


def _roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_with_jax_and_vlog_tpu_blocked():
    script = _BLOCKED_IMPORT_SCRIPT.format(blocked=BLOCKED, root=str(ROOT),
                                           http_plane=HTTP_PLANE,
                                           reexports=REEXPORTS)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


def test_no_source_names_jax_or_vlog_tpu():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for path in files:
        bad = _roots(ast.parse(path.read_text())) & set(BLOCKED)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
