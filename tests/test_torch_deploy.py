"""The port's deployment tree, ``deploy/gpu/``, stays sound, as
``tests/test_deploy_artifacts.py`` keeps ``deploy/``: every manifest
parses with its kind and name, the HPA targets a Deployment that exists,
the PDBs select a Deployment's pods, the CronJobs forbid overlap and
avoid the :00 and :30 minutes, the systemd units restart (the worker's
on exit 64), every ``vlog_tpu_torch.*`` module named anywhere resolves,
nothing names a ``vlog_tpu.`` module or a TPU resource, the Dockerfile
copies only the port and its warm-up step parses as Python, and the
image's ENTRYPOINT module answers ``--help``.
"""

from __future__ import annotations

import ast
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parent.parent
GPU = ROOT / "deploy" / "gpu"
DOCKERFILE = GPU / "Dockerfile.worker-gpu"
MANIFESTS = sorted((GPU / "k8s").glob("*.yaml"))
UNITS = sorted((GPU / "systemd").glob("*.service"))
FILES = sorted(p for p in GPU.rglob("*") if p.is_file())


def _docs(path: Path) -> list[dict]:
    return [d for d in yaml.safe_load_all(path.read_text()) if d is not None]


def _all_docs() -> list[dict]:
    return [d for f in MANIFESTS for d in _docs(f)]


def _deployments() -> dict[str, dict]:
    return {d["metadata"]["name"]: d for d in _all_docs()
            if d["kind"] == "Deployment"}


@pytest.mark.parametrize("path", MANIFESTS, ids=lambda p: p.name)
def test_manifest_parses_with_kind_and_name(path):
    docs = _docs(path)
    assert docs
    for doc in docs:
        assert doc.get("apiVersion"), path
        assert doc.get("kind"), path
        assert doc.get("metadata", {}).get("name"), path


def test_manifests_cover_the_fleet_families():
    assert {p.name for p in MANIFESTS} == {
        "worker-gpu.yaml", "services.yaml", "worker-autoscaling.yaml",
        "maintenance-cronjobs.yaml", "network-policy.yaml"}
    assert {"Deployment", "Service", "HorizontalPodAutoscaler",
            "PodDisruptionBudget", "NetworkPolicy",
            "CronJob"} <= {d["kind"] for d in _all_docs()}


def test_worker_deployment_takes_one_gpu():
    worker = _deployments()["vlog-worker-gpu"]
    spec = worker["spec"]["template"]["spec"]
    (container,) = spec["containers"]
    for key in ("requests", "limits"):
        assert container["resources"][key] == {"nvidia.com/gpu": "1"}
    assert spec.get("nodeSelector") or spec.get("tolerations")
    # the drain finishes before SIGKILL
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert int(env["VLOG_DRAIN_GRACE_S"]) < spec["terminationGracePeriodSeconds"]
    assert container["livenessProbe"]["httpGet"]["path"] == "/health"
    assert container["readinessProbe"]["httpGet"]["path"] == "/ready"
    assert any(a.startswith("--accelerator=") for a in container["args"])


def test_hpa_targets_an_existing_deployment():
    hpa = next(d for d in _all_docs()
               if d["kind"] == "HorizontalPodAutoscaler")
    ref = hpa["spec"]["scaleTargetRef"]
    assert ref["kind"] == "Deployment" and ref["name"] in _deployments()
    assert ref["name"] == "vlog-worker-gpu"
    assert hpa["spec"]["minReplicas"] >= 1


def test_pdb_selectors_match_deployment_labels():
    labels = [d["spec"]["selector"]["matchLabels"]
              for d in _deployments().values()]
    pdbs = [d for d in _all_docs() if d["kind"] == "PodDisruptionBudget"]
    assert pdbs
    for pdb in pdbs:
        assert pdb["spec"]["selector"]["matchLabels"] in labels, \
            pdb["metadata"]["name"]
    # a PDB named in two files is one object: the two must agree
    by_name: dict[str, dict] = {}
    for pdb in pdbs:
        assert by_name.setdefault(pdb["metadata"]["name"], pdb) == pdb


def test_network_policies_select_deployed_pods():
    labels = [d["spec"]["selector"]["matchLabels"]
              for d in _deployments().values()]
    for pol in (d for d in _all_docs() if d["kind"] == "NetworkPolicy"):
        assert pol["spec"]["podSelector"]["matchLabels"] in labels


def test_cronjobs_forbid_concurrency_and_parse_schedules():
    crons = [d for d in _docs(GPU / "k8s" / "maintenance-cronjobs.yaml")
             if d["kind"] == "CronJob"]
    assert len(crons) == 3
    for c in crons:
        assert c["spec"]["concurrencyPolicy"] == "Forbid"
        fields = c["spec"]["schedule"].split()
        assert len(fields) == 5, c["metadata"]["name"]
        assert fields[0] not in ("0", "30")


def test_systemd_units_restart():
    assert len(UNITS) == 4
    for unit in UNITS:
        text = unit.read_text()
        assert "Restart=" in text, unit.name
        assert "ExecStart=" in text and "vlog_tpu_torch." in text, unit.name
    worker = (GPU / "systemd" / "vlog-torch-worker.service").read_text()
    assert "vlog_tpu_torch.worker.daemon" in worker
    assert "RestartForceExitStatus=64" in worker


_TOKEN = re.compile(r"vlog_tpu_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(GPU)))
def test_every_port_module_named_resolves(path):
    for token in set(_TOKEN.findall(path.read_text())):
        assert importlib.util.find_spec(token) is not None, (
            f"{path.name} names a missing module {token}")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(GPU)))
def test_nothing_names_the_jax_package_or_a_tpu(path):
    text = path.read_text()
    assert not re.search(r"\bvlog_tpu\.", text), path.name
    assert "google.com/tpu" not in text, path.name


def _warm_up() -> str:
    """The body of the Dockerfile's ``RUN python - <<'PY'`` heredoc."""
    text = DOCKERFILE.read_text()
    m = re.search(r"^RUN python - <<'PY'\n(.*?)^PY$", text, re.S | re.M)
    assert m, "no warm-up heredoc"
    return m.group(1)


def test_dockerfile_copies_only_the_port_and_warms_both_builds():
    text = DOCKERFILE.read_text()
    copies = [ln.split()[1] for ln in text.splitlines()
              if ln.startswith("COPY ")]
    assert copies == ["vlog_tpu_torch"]
    assert re.search(r"^FROM nvidia/cuda:[^ ]*devel", text, re.M)
    code = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith("#"))
    for dep in ("numpy", "scipy", "aiohttp", "prometheus-client",
                "transformers", "safetensors", "torch"):
        assert dep in code, dep
    for dep in ("argon2-cffi", "httpx", "jax"):
        assert dep not in code, dep
    body = _warm_up()
    tree = ast.parse(body)
    imported = {(n.module, a.name) for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert ("vlog_tpu_torch.native.build", "get_lib") in imported
    assert ("vlog_tpu_torch.ops.fused_resize", "build_library") in imported
    assert {("vlog_tpu_torch.ops", "motion_search"),
            ("vlog_tpu_torch.ops", "h264_deblock")} <= imported


def _entrypoint() -> list[str]:
    line = next(ln for ln in DOCKERFILE.read_text().splitlines()
                if ln.startswith("ENTRYPOINT "))
    return ast.literal_eval(line[len("ENTRYPOINT "):])


def test_entrypoint_module_answers_help():
    entry = _entrypoint()
    assert entry[:2] == ["python", "-m"]
    assert entry[2] == "vlog_tpu_torch.worker.remote"
    proc = subprocess.run([sys.executable, "-m", entry[2], "--help"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--accelerator" in proc.stdout
    cmd = next(ln for ln in DOCKERFILE.read_text().splitlines()
               if ln.startswith("CMD "))
    accel = ast.literal_eval(cmd[len("CMD "):])
    value = accel[accel.index("--accelerator") + 1]
    assert re.search(r"\{[^}]*\b" + value + r"\b", proc.stdout), proc.stdout
