"""Port parity, the `kubernetes` command (trivy_tpu_torch/k8s/, the
kubernetes slice of trivy_tpu_torch/iac/ and misconf/, cli/run.py
`run_k8s`) against the JAX package's on the CPU: manifest parsing, the
RBAC, infra and node assessments, each of the 42 KSV checks on a manifest
that fails it and one that passes it, `#trivy:ignore` comments, cluster
scans of a seeded cluster (`chip_smoke.k8s_cluster`, seed 20261022)
rendered as JSON and both tables, image-tar vulnerability and secret
results, the CLI byte for byte, the API-server client and the node
collector against stdlib fake API servers, and the port's departures
and refusals.

The port runs its image scans with `--device cpu` (the match kernel's
and the secret screens' plain versions) or `--no-tpu`; the reference
runs its JAX engine on the CPU. Every report embeds the clock, which
both packages read from TRIVY_TPU_FAKE_TIME.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch
import yaml
from test_fanal import APK_INSTALLED, OS_RELEASE, _fixture_db
from test_k8s import APISERVER, BAD_ROLE, CRONJOB, DEPLOY, NODE_INFO
from test_k8s import _FakeAPIServer
from test_k8s_apiserver import TOKEN, _Handler, _kubeconfig, _StubState

import chip_smoke
from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.iac import check as jax_check
from trivy_tpu_torch.cli import config, run
from trivy_tpu_torch.cli.main import build_parser, main
from trivy_tpu_torch.device import DeviceError
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.iac import check as port_check

FAKE_TIME = "2024-01-01T00:00:00+00:00"
SEED = 20261022
PKGS = ("trivy_tpu", "trivy_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def both(name: str):
    """-> (the reference's module, the port's) of `name`."""
    return tuple(mod(p, name) for p in PKGS)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and idle OpenMP workers spin on cores their neighbours' timing
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """Both packages' clocks pinned; no engine or kubeconfig carried in
    from another test."""
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    for key in list(os.environ):
        if key.startswith("TRIVY_TPU_") and key != "TRIVY_TPU_FAKE_TIME":
            monkeypatch.delenv(key)
    monkeypatch.delenv("KUBECONFIG", raising=False)
    yield
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


def resources(res) -> list:
    return [(r.kind, r.name, r.namespace, r.images, r.fullname, r.raw)
            for r in res]


def findings(fs) -> list:
    return [dataclasses.astuple(f) for f in fs]


# ------------------------------------------------------------- the cluster


def image_tar(path: str, k: int) -> None:
    """A small alpine image archive: the reference tests' apk database
    (musl and busybox hold advisories of the fixture DB), a lockfile with
    a vulnerable lodash, and one planted secret of the image's own.
    Image 0 is an OCI layout, the others docker-save."""
    lock = {"name": f"app{k}", "lockfileVersion": 3, "packages": {
        "": {"name": f"app{k}", "version": "1.0.0"},
        "node_modules/lodash": {"version": "4.17.4"}}}
    layer = chip_smoke.layer_tar([
        ("etc/os-release", OS_RELEASE),
        ("lib/apk/db/installed", APK_INSTALLED),
        (f"srv/app{k}/package-lock.json", json.dumps(lock)),
        (f"srv/app{k}/deploy.txt", f"token ghp_{chr(97 + k) * 36}\n")])
    chip_smoke.write_image(path, [layer], [{"created_by": f"COPY app{k}"}],
                           "oci" if k == 0 else "docker")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A seeded cluster of 202 resources (5 namespaces of 18 Deployments
    and 18 Services, a Role and a RoleBinding each; the cluster-wide
    RBAC, three control-plane Pods, three NodeInfo documents) as
    manifests, three workload images resolving to archives of the
    image-tar directory (a pinned tag, `:latest`, none), and the fixture
    DB saved."""
    root = tmp_path_factory.mktemp("k8s")
    tars = []
    for k in range(3):
        tars.append(str(root / f"img{k}.tar"))
        image_tar(tars[-1], k)
    tar_dir = root / "tars"
    tar_dir.mkdir()
    refs = chip_smoke.k8s_image_refs(tars)
    for tar, name in zip(tars, refs.values()):
        os.symlink(tar, tar_dir / name)
    docs = chip_smoke.k8s_cluster(np.random.default_rng(SEED), 5, 18,
                                  list(refs))
    manifests = root / "manifests"
    chip_smoke.write_k8s_manifests(docs, str(manifests))
    _fixture_db().save(str(root / "db"))
    return {"docs": docs, "manifests": str(manifests),
            "tar_dir": str(tar_dir), "db": str(root / "db"),
            "images": list(refs), "root": root}


def test_seeded_cluster_shape(cluster):
    kinds: dict = {}
    for d in cluster["docs"]:
        kinds[d["kind"]] = kinds.get(d["kind"], 0) + 1
    assert kinds == {"Deployment": 90, "Service": 90, "Role": 5,
                     "RoleBinding": 5, "ClusterRole": 4,
                     "ClusterRoleBinding": 2, "Pod": 3, "NodeInfo": 3}
    again = chip_smoke.k8s_cluster(np.random.default_rng(SEED), 5, 18,
                                   cluster["images"])
    assert again == cluster["docs"]


# ----------------------------------------------------------- enumeration


JSON_LIST = json.dumps({"apiVersion": "v1", "kind": "List", "items": [
    yaml.safe_load(DEPLOY.split(b"---")[0]),
    {"apiVersion": "v1", "kind": "ConfigMap",
     "metadata": {"name": "cfg", "namespace": "prod"}}]}).encode()
YAML_LIST = b"""apiVersion: v1
kind: PodList
items:
  - apiVersion: v1
    kind: Pod
    metadata: {name: a, namespace: x}
    spec:
      ephemeralContainers: [{name: dbg, image: busybox}]
      containers: [{name: c, image: "nginx@sha256:abc"}]
"""


@pytest.mark.parametrize("content", [
    DEPLOY, CRONJOB, BAD_ROLE, APISERVER, json.dumps(NODE_INFO).encode(),
    JSON_LIST, YAML_LIST, b"kind: [unclosed", b"{not json", b"- a\n- b\n",
    b"apiVersion: v1\nmetadata: {name: kindless}\n"],
    ids=["deploy", "cronjob", "rbac", "apiserver", "nodeinfo", "json-list",
         "yaml-list", "bad-yaml", "bad-json", "yaml-sequence", "no-kind"])
def test_parse_manifest_docs(content):
    ref, port = both("k8s.artifacts")
    assert resources(port.parse_manifest_docs(content)) == \
        resources(ref.parse_manifest_docs(content))


def test_load_manifests(cluster, tmp_path):
    ref, port = both("k8s.artifacts")
    got = port.load_manifests(cluster["manifests"])
    assert resources(got) == resources(ref.load_manifests(
        cluster["manifests"]))
    assert len(got) == 202
    one = os.path.join(cluster["manifests"], "team-00.yaml")
    assert resources(port.load_manifests(one)) == \
        resources(ref.load_manifests(one))
    for m in (ref, port):
        with pytest.raises(RuntimeError, match="no such manifest"):
            m.load_manifests(str(tmp_path / "absent"))


@pytest.mark.parametrize("which", ["rbac", "infra", "node"])
def test_assessments(cluster, which):
    """assess_rbac, assess_infra and assess_node_info over the seeded
    cluster and the reference tests' fixtures."""
    docs = DEPLOY + b"\n---\n" + BAD_ROLE + b"\n---\n" + APISERVER
    outs = []
    for pkg in PKGS:
        res = (mod(pkg, "k8s.artifacts").load_manifests(cluster["manifests"])
               + mod(pkg, "k8s.artifacts").parse_manifest_docs(docs))
        if which == "rbac":
            outs.append(findings(mod(pkg, "k8s.rbac").assess_rbac(res)))
        elif which == "infra":
            outs.append(findings(mod(pkg, "k8s.infra").assess_infra(res)))
        else:
            nc = mod(pkg, "k8s.node_collector")
            outs.append([findings(nc.assess_node_info(d)) for d in
                         [NODE_INFO, *(r.raw for r in res
                                       if r.kind == "NodeInfo")]])
    assert outs[1] == outs[0]
    assert outs[1] and (which != "node" or all(outs[1]))


# ---------------------------------------------------------------- checks


def registry(m) -> list:
    return [(c.id, c.avd_id, c.title, c.description, c.resolution,
             c.severity, c.file_types, c.provider, c.service, c.url,
             c.namespace, c.deprecated) for c in m.checks_for("kubernetes")]


def test_check_registry_equals_the_reference():
    """checks_for("kubernetes"): the same 42 checks, ids, titles,
    severities and URLs, among the same builtins of every file type."""
    from trivy_tpu_torch.iac import engine

    got = registry(port_check)
    assert got == registry(jax_check)
    assert len(got) == 42
    assert {c.id for c in port_check.all_checks()} == \
        {c.id for c in jax_check.all_checks()}
    # the scan-wide check set: the builtins alone, installed and reset
    default = engine.active()
    assert registry(default) == got
    installed = engine.configure()
    try:
        assert engine.active() is installed is not default
        assert registry(installed) == got
    finally:
        engine.reset()
    assert engine.active() is default


BASE_DEPLOY = {
    "apiVersion": "apps/v1", "kind": "Deployment",
    "metadata": {"name": "app", "namespace": "prod"},
    "spec": {"template": {"metadata": {"labels": {"app": "app"}}, "spec": {
        "automountServiceAccountToken": False,
        "securityContext": {"runAsNonRoot": True, "runAsUser": 20000,
                            "runAsGroup": 20000,
                            "seccompProfile": {"type": "RuntimeDefault"}},
        "containers": [{
            "name": "app", "image": "registry.example.com/app:1.2.3",
            "securityContext": {"allowPrivilegeEscalation": False,
                                "readOnlyRootFilesystem": True,
                                "capabilities": {"drop": ["ALL"]}},
            "resources": {"limits": {"cpu": "500m", "memory": "256Mi"},
                          "requests": {"cpu": "100m",
                                       "memory": "128Mi"}},
            "ports": [{"containerPort": 8080}]}]}}}}
BASE_ROLE = {
    "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
    "metadata": {"name": "reader", "namespace": "prod"},
    "rules": [{"apiGroups": [""], "resources": ["pods"],
               "verbs": ["get", "list"]}]}


def _pod(d):
    return d["spec"]["template"]["spec"]


def _c(d):
    return _pod(d)["containers"][0]


def _csc(d):
    return _c(d)["securityContext"]


def _psc(d):
    return _pod(d)["securityContext"]


def _rule(resource: str, verb: str):
    def mutate(d):
        d["rules"].append({"apiGroups": [""], "resources": [resource],
                           "verbs": [verb]})
    return mutate


# check id -> (the passing manifest, a change that makes it fail)
CHECK_CASES = {
    "KSV001": (BASE_DEPLOY, lambda d: _csc(d).update(
        allowPrivilegeEscalation=True)),
    "KSV002": (BASE_DEPLOY, lambda d: d["spec"]["template"][
        "metadata"].update(annotations={
            "container.apparmor.security.beta.kubernetes.io/app":
            "unconfined"})),
    "KSV003": (BASE_DEPLOY, lambda d: _csc(d).update(
        capabilities={"drop": ["NET_RAW"]})),
    "KSV005": (BASE_DEPLOY, lambda d: _csc(d)["capabilities"].update(
        add=["SYS_ADMIN"])),
    "KSV006": (BASE_DEPLOY, lambda d: _pod(d).update(volumes=[
        {"name": "d", "hostPath": {"path": "/var/run/docker.sock"}}])),
    "KSV007": (BASE_DEPLOY, lambda d: _pod(d).update(hostAliases=[
        {"ip": "127.0.0.1", "hostnames": ["db.local"]}])),
    "KSV008": (BASE_DEPLOY, lambda d: _pod(d).update(hostIPC=True)),
    "KSV009": (BASE_DEPLOY, lambda d: _pod(d).update(hostNetwork=True)),
    "KSV010": (BASE_DEPLOY, lambda d: _pod(d).update(hostPID=True)),
    "KSV011": (BASE_DEPLOY, lambda d: _c(d)["resources"]["limits"].pop(
        "cpu")),
    "KSV012": (BASE_DEPLOY, lambda d: _psc(d).update(runAsNonRoot=False)),
    "KSV013": (BASE_DEPLOY, lambda d: _c(d).update(image="app:latest")),
    "KSV014": (BASE_DEPLOY, lambda d: _csc(d).update(
        readOnlyRootFilesystem=False)),
    "KSV015": (BASE_DEPLOY, lambda d: _c(d)["resources"]["requests"].pop(
        "cpu")),
    "KSV016": (BASE_DEPLOY, lambda d: _c(d)["resources"]["requests"].pop(
        "memory")),
    "KSV017": (BASE_DEPLOY, lambda d: _csc(d).update(privileged=True)),
    "KSV018": (BASE_DEPLOY, lambda d: _c(d)["resources"]["limits"].pop(
        "memory")),
    "KSV020": (BASE_DEPLOY, lambda d: _psc(d).update(runAsUser=1000)),
    "KSV021": (BASE_DEPLOY, lambda d: _psc(d).update(runAsGroup=1000)),
    "KSV022": (BASE_DEPLOY, lambda d: _csc(d)["capabilities"].update(
        add=["NET_ADMIN"])),
    "KSV023": (BASE_DEPLOY, lambda d: _pod(d).update(volumes=[
        {"name": "h", "hostPath": {"path": "/data"}}])),
    "KSV024": (BASE_DEPLOY, lambda d: _c(d).update(ports=[
        {"containerPort": 8080, "hostPort": 8080}])),
    "KSV025": (BASE_DEPLOY, lambda d: _psc(d).update(
        seLinuxOptions={"user": "system_u"})),
    "KSV026": (BASE_DEPLOY, lambda d: _psc(d).update(
        sysctls=[{"name": "kernel.msgmax", "value": "65536"}])),
    "KSV027": (BASE_DEPLOY, lambda d: _csc(d).update(
        procMount="Unmasked")),
    "KSV028": (BASE_DEPLOY, lambda d: _pod(d).update(volumes=[
        {"name": "n", "nfs": {"server": "nfs.local", "path": "/"}}])),
    "KSV029": (BASE_DEPLOY, lambda d: _psc(d).update(runAsGroup=0)),
    "KSV030": (BASE_DEPLOY, lambda d: _psc(d).update(
        seccompProfile={"type": "Unconfined"})),
    "KSV036": (BASE_DEPLOY, lambda d: _pod(d).update(
        automountServiceAccountToken=True)),
    "KSV037": (BASE_DEPLOY, lambda d: d["metadata"].update(
        namespace="kube-system")),
    "KSV041": (BASE_ROLE, _rule("secrets", "create")),
    "KSV042": (BASE_ROLE, _rule("pods/log", "delete")),
    "KSV045": (BASE_ROLE, _rule("pods", "*")),
    "KSV046": (BASE_ROLE, _rule("*", "*")),
    "KSV049": (BASE_ROLE, _rule("configmaps", "update")),
    "KSV050": (BASE_ROLE, _rule("rolebindings", "bind")),
    "KSV102": (BASE_DEPLOY, lambda d: _c(d).update(
        image="gcr.io/kubernetes-helm/tiller:v2.16.0")),
    "KSV103": (BASE_DEPLOY, lambda d: _csc(d).update(
        windowsOptions={"hostProcess": True})),
    "KSV104": (BASE_DEPLOY, lambda d: _psc(d).pop("seccompProfile")),
    "KSV105": (BASE_DEPLOY, lambda d: _csc(d).update(runAsUser=0)),
    "KSV106": (BASE_DEPLOY, lambda d: _csc(d)["capabilities"].update(
        add=["CHOWN"])),
    "KSV117": (BASE_DEPLOY, lambda d: _c(d).update(ports=[
        {"containerPort": 80}])),
}
REFERENCE_IDS = [c.id for c in jax_check.checks_for("kubernetes")]


def scan_both(content: bytes, path: str = "prod/Deployment/app.yaml"):
    """scan_config(..., file_type="kubernetes") of both packages: (the
    reference's Misconfiguration as a dict, the port's)."""
    out = []
    for pkg in PKGS:
        m = mod(pkg, "misconf.scanner").scan_config(
            path, content, file_type="kubernetes")
        out.append(None if m is None else m.to_dict())
    return out


def test_check_cases_cover_the_registry():
    assert sorted(CHECK_CASES) == sorted(REFERENCE_IDS)


@pytest.mark.parametrize("check_id", REFERENCE_IDS)
def test_check(check_id):
    """A manifest that fails the check and one that passes it, each as
    the cluster scanner writes a resource (YAML, keys in order): equal
    Misconfigurations in both packages, the check among the failures of
    the first and the successes of the second."""
    passing, mutate = CHECK_CASES[check_id]
    failing = copy.deepcopy(passing)
    mutate(failing)
    for doc, where in ((failing, "Failures"), (passing, "Successes")):
        content = yaml.safe_dump(doc, sort_keys=False).encode()
        want, got = scan_both(content)
        assert got == want
        assert check_id in {m["ID"] for m in got.get(where, [])}


IGNORED = yaml.safe_dump(BASE_DEPLOY, sort_keys=False)


@pytest.mark.parametrize("case", [
    ("trailing", "    image: nginx  # trivy:ignore:KSV013\n"),
    ("avd-id", "    image: nginx  # trivy:ignore:AVD-KSV-0013\n"),
    ("wildcard", "    image: nginx  # trivy:ignore:*\n"),
    ("standalone", "    # trivy:ignore:KSV013\n    image: nginx\n"),
    ("stacked", "    # trivy:ignore:KSV013\n    # trivy:ignore:KSV011\n"
                "    image: nginx\n"),
    ("blank-breaks", "    # trivy:ignore:KSV013\n\n    image: nginx\n"),
    ("expired", "    image: nginx  # trivy:ignore:KSV013:exp:2023-12-31\n"),
    ("not-expired",
     "    image: nginx  # trivy:ignore:KSV013:exp:2024-01-01\n"),
    ("bad-date", "    image: nginx  # trivy:ignore:KSV013:exp:2024-13-01\n"),
    ("workspace", "    image: nginx  # tfsec:ignore:KSV013:ws:dev*\n"),
    ("other-rule", "    image: nginx  # trivy:ignore:KSV999\n")],
    ids=lambda c: c[0])
def test_ignore_comments(case):
    """`#trivy:ignore` comments on a pod whose one container's image
    line fails KSV013 (among others), with the clock pinned."""
    name, image_line = case
    content = ("apiVersion: v1\nkind: Pod\nmetadata:\n  name: p\n"
               "spec:\n  containers:\n  - name: c\n" + image_line
               ).encode()
    want, got = scan_both(content, "default/Pod/p.yaml")
    assert got == want
    ignored = "KSV013" not in {m["ID"] for m in got.get("Failures", [])}
    assert ignored == (name in ("trailing", "avd-id", "wildcard",
                                "standalone", "stacked", "not-expired"))


@pytest.mark.parametrize("content", [
    json.dumps(BASE_DEPLOY).encode(), JSON_LIST, YAML_LIST,
    DEPLOY + b"\n---\n" + CRONJOB, IGNORED.encode(),
    b"kind: Pod\nmetadata: {name: no-api-version}\n", b"", b"[1, 2]"],
    ids=["json", "json-list", "yaml-list", "multi-doc", "hardened",
         "no-api-version", "empty", "json-array"])
def test_scan_config_shapes(content):
    want, got = scan_both(content)
    assert got == want


# --------------------------------------------------------- cluster scans


def cluster_scan(pkg: str, cluster, scanners: set) -> tuple:
    sc = mod(pkg, "k8s.scanner").ClusterScanner(scanners=set(scanners))
    report = sc.scan(cluster["manifests"])
    rep = mod(pkg, "k8s.report")
    return (json.dumps(rep.to_dict(report), indent=2),
            rep.render_summary(report), rep.render_all(report))


@pytest.mark.parametrize("scanners", [
    ("misconfig", "rbac", "infra"), ("misconfig",), ("rbac",), ("infra",),
    ("vuln",)], ids="+".join)
def test_cluster_scan(cluster, scanners):
    """ClusterScanner.scan of the seeded cluster: to_dict's JSON bytes,
    render_summary and render_all equal."""
    want = cluster_scan("trivy_tpu", cluster, scanners)
    got = cluster_scan("trivy_tpu_torch", cluster, scanners)
    assert got == want
    assert "Workload Assessment" in got[1]


# ------------------------------------------------------------------- CLI


def force_device_screen(monkeypatch):
    """Make the secret analyzer take the device path whatever the CLI
    set: on the CPU that is the screens' plain versions."""
    orig = secret_analyzer.SecretAnalyzer.post_analyze

    def forced(self, files):
        secret_analyzer.USE_DEVICE = True
        return orig(self, files)

    monkeypatch.setattr(secret_analyzer.SecretAnalyzer, "post_analyze",
                        forced)


_REFERENCE_OUT: dict = {}

FORMATS = {"json": ["--format", "json"], "summary": [],
           "all": ["--report", "all"]}


def k8s_argv(cluster, fmt: str, vuln: bool, tmp) -> list[str]:
    argv = ["kubernetes", cluster["manifests"], "--quiet", "--cache-dir",
            str(tmp), *FORMATS[fmt]]
    if vuln:
        argv += ["--scanners", "vuln,misconfig,rbac,infra",
                 "--image-tar-dir", cluster["tar_dir"], "--db-path",
                 cluster["db"]]
    return argv


def reference_out(cluster, fmt: str, vuln: bool, capsys) -> str:
    """The reference CLI's stdout (its JAX engine on the CPU), once per
    format and scanner set."""
    key = (fmt, vuln)
    if key not in _REFERENCE_OUT:
        rc = jax_main.main(k8s_argv(cluster, fmt, vuln,
                                    cluster["root"] / "jcache"))
        assert rc == 0
        _REFERENCE_OUT[key] = capsys.readouterr().out
    return _REFERENCE_OUT[key]


@pytest.mark.parametrize("mode", ["none", "device", "no-tpu"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_cli_equals_the_reference(cluster, tmp_path, capsys, monkeypatch,
                                  fmt, mode):
    """`kubernetes DIR` in json and both tables byte for byte, without
    image scans (the default scanners: no device needed, none named) and
    with `vuln` on the port's device (the plain match and screens) or
    --no-tpu."""
    vuln = mode != "none"
    want = reference_out(cluster, fmt, vuln, capsys)
    argv = k8s_argv(cluster, fmt, vuln, tmp_path / "pcache")
    if mode == "device":
        force_device_screen(monkeypatch)
        argv += ["--device", "cpu"]
    elif mode == "no-tpu":
        argv.append("--no-tpu")
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    if fmt == "json" and vuln:
        doc = json.loads(got)
        scanned = {v["Image"]: v["Report"] for r in doc["Resources"]
                   for v in r.get("Vulnerabilities", [])}
        assert sorted(scanned) == sorted(cluster["images"])
        for rep in scanned.values():
            ids = {v["VulnerabilityID"] for r in rep["Results"]
                   for v in r.get("Vulnerabilities") or []}
            assert {"CVE-2025-1000", "CVE-2019-10744"} <= ids
            assert sum(len(r.get("Secrets") or [])
                       for r in rep["Results"]) >= 1
    if vuln:
        from trivy_tpu_torch.k8s import scanner as k8s_scanner

        assert set(k8s_scanner.STATS) == {
            "enumerate_s", "misconfig_s", "rbac_infra_s", "images_s"}


def test_cli_output_file_and_alias(cluster, tmp_path, capsys):
    """`k8s -o FILE` writes what `kubernetes` prints."""
    out = tmp_path / "report.json"
    assert main(["k8s", cluster["manifests"], "--quiet", "--format", "json",
                 "-o", str(out)]) == 0
    assert capsys.readouterr().out == ""
    assert out.read_text() == reference_out(cluster, "json", False, capsys)


@pytest.mark.parametrize("args", [
    ["--scanners", "vuln,bogus"], ["--scanners", "secret"]],
    ids=["bogus", "secret"])
def test_unknown_scanners(cluster, capsys, args):
    """An unknown scanner fails at once with the reference's message."""
    argv = ["kubernetes", cluster["manifests"], *args]
    bad = args[1].split(",")[-1]
    line = (f"unknown k8s scanners: {bad} "
            "(valid: infra, misconfig, rbac, vuln)")
    for entry in (jax_main.main, main):
        assert entry(argv) == 1
        got = capsys.readouterr()
        assert got.out == "" and line in got.err


def test_namespace_flag_on_manifests(cluster, capsys):
    """--namespace restricts a live scan only; on manifests both
    packages ignore it alike."""
    argv = ["kubernetes", cluster["manifests"], "--quiet", "-f", "json",
            "-n", "team-01"]
    assert jax_main.main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    assert capsys.readouterr().out == want


# ------------------------------------------------- API client, live scans


@pytest.fixture()
def stub_server():
    """tests/test_k8s_apiserver.py's stub API server."""
    import threading
    from http.server import HTTPServer

    state = _StubState()
    handler = type("H", (_Handler,), {"state": state})
    srv = HTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}", state
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5)


def client_outcome(pkg: str, op: str, server: str, tmp_path, monkeypatch):
    """What the package's KubeClient does in `op`: its result, or its
    error's type name and message."""
    client_mod = mod(pkg, "k8s.client")
    try:
        if op == "token":
            return client_mod.KubeClient(config_path=_kubeconfig(
                tmp_path, server)).version()
        if op == "context":
            return client_mod.KubeClient(
                context="stub-ctx", config_path=_kubeconfig(
                    tmp_path, server, current=False)).version()
        if op == "bad-token":
            return client_mod.KubeClient(config_path=_kubeconfig(
                tmp_path, server, token="wrong")).version()
        if op == "missing":
            return client_mod.KubeClient(
                config_path=str(tmp_path / "nope"))
        if op == "list":
            return client_mod.KubeClient(config_path=_kubeconfig(
                tmp_path, server)).list("Pod")
        if op == "service-account":
            sa = tmp_path / "sa"
            sa.mkdir(exist_ok=True)
            (sa / "token").write_text(TOKEN)
            monkeypatch.setattr(client_mod, "SA_DIR", str(sa))
            host, port = server.removeprefix("http://").split(":")
            monkeypatch.setenv("KUBERNETES_SERVICE_HOST", host)
            monkeypatch.setenv("KUBERNETES_SERVICE_PORT", port)
            c = client_mod.KubeClient(config_path=str(tmp_path / "absent"))
            server_was = c.server
            c.server = server  # in-cluster is https; the stub is http
            return server_was, c.version()
    except Exception as e:
        return type(e).__name__, str(e).replace(str(tmp_path), "TMP")
    raise AssertionError(op)


@pytest.mark.parametrize("op", ["token", "context", "bad-token", "missing",
                                "list", "service-account"])
def test_kube_client(stub_server, tmp_path, monkeypatch, op):
    """The stdlib API-server client of both packages against
    tests/test_k8s_apiserver.py's stub: bearer-token auth, context
    selection, the in-cluster service account, a bad token, a missing
    kubeconfig, and `list` filling kind and apiVersion."""
    server, state = stub_server
    want = client_outcome("trivy_tpu", op, server, tmp_path, monkeypatch)
    n = len(state.requests)
    got = client_outcome("trivy_tpu_torch", op, server, tmp_path,
                         monkeypatch)
    assert got == want
    assert state.requests[n:] == state.requests[:n]
    if op == "list":
        assert got[0]["kind"] == "Pod" and got[0]["apiVersion"] == "v1"
    if op in ("token", "service-account"):
        assert state.requests[-1][2] == f"Bearer {TOKEN}"


@pytest.fixture()
def fake_apiserver(tmp_path, monkeypatch):
    """tests/test_k8s.py's fake API server with KUBECONFIG at it."""
    srv = _FakeAPIServer()
    url = srv.start()
    kubeconfig = tmp_path / "config"
    kubeconfig.write_text(
        "apiVersion: v1\nkind: Config\ncurrent-context: test\n"
        "contexts:\n  - name: test\n    context:\n"
        "      cluster: c1\n      user: u1\n"
        "clusters:\n  - name: c1\n    cluster:\n"
        f"      server: {url}\n"
        "users:\n  - name: u1\n    user:\n      token: tok123\n")
    monkeypatch.setenv("KUBECONFIG", str(kubeconfig))
    yield url
    srv.stop()


def test_load_cluster_api(fake_apiserver):
    ref, port = both("k8s.artifacts")
    got = port.load_cluster_api()
    assert resources(got) == resources(ref.load_cluster_api())
    assert {r.kind for r in got} == {"Pod", "Deployment", "ClusterRole"}


def test_load_cluster_without_credentials(tmp_path, monkeypatch):
    """No kubeconfig, no service account and no kubectl: load_cluster
    fails as the reference's does (kubectl is only the last resort)."""
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "absent"))
    monkeypatch.setenv("PATH", str(tmp_path))
    outs = []
    for pkg in PKGS:
        art = mod(pkg, "k8s.artifacts")
        monkeypatch.setattr(mod(pkg, "k8s.client"), "SA_DIR",
                            str(tmp_path / "no-sa"))
        with pytest.raises(RuntimeError) as e:
            art.load_cluster()
        outs.append(str(e.value))
    assert outs[1] == outs[0]
    assert "no kubectl" in outs[1]


@pytest.fixture()
def live_cluster(cluster, tmp_path, monkeypatch):
    """chip_smoke's KubeAPIFake serving the seeded cluster, KUBECONFIG at
    it."""
    fake = chip_smoke.KubeAPIFake(cluster["docs"])
    url = fake.start()
    monkeypatch.setenv("KUBECONFIG", fake.kubeconfig(
        url, str(tmp_path / "kubeconfig")))
    yield fake
    fake.stop()


@pytest.mark.parametrize("extra", [
    [], ["--disable-node-collector"], ["--namespace", "team-01"],
    ["--node-collector-namespace", "scan-tmp",
     "--node-collector-imageref", "collector:1"]],
    ids=["collector", "no-collector", "namespace", "collector-flags"])
def test_live_cluster_cli(cluster, live_cluster, capsys, tmp_path, extra):
    """`kubernetes cluster` against a fake API server serving the seeded
    cluster: both packages' JSON equal; the node collector's Jobs run,
    their NodeInfo logs assessed, every Job deleted; its findings are
    those of the manifests' NodeInfo documents, and gone without the
    collector."""
    argv = ["kubernetes", "cluster", "--quiet", "-f", "json",
            "--cache-dir", str(tmp_path), *extra]
    assert jax_main.main(argv) == 0
    want = capsys.readouterr().out
    ref_requests = dict(live_cluster.requests)
    live_cluster.requests.clear()
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    assert live_cluster.requests == ref_requests
    assert live_cluster.jobs == {}
    doc = json.loads(got)
    nodes = [f for f in doc["InfraAssessment"]
             if f["Resource"].startswith("Node/")]
    if "--namespace" in extra:
        assert {r["Namespace"] for r in doc["Resources"]} == {"team-01"}
    if "--disable-node-collector" in extra:
        assert nodes == [] and "job_create" not in live_cluster.requests
    else:
        assert live_cluster.requests["job_create"] == 3
        assert live_cluster.requests["job_delete"] == 3
        manifests = json.loads(reference_out(cluster, "json", False, capsys))
        assert sorted(map(json.dumps, nodes)) == sorted(
            json.dumps(f) for f in manifests["InfraAssessment"]
            if f["Resource"].startswith("Node/"))


# ------------------------------------------------------- node collector


@pytest.mark.parametrize("node", [
    "worker-1", "Worker_1.Example.com", "node-" + "a" * 200 + "-one",
    "node-" + "a" * 200 + "-two", "---"])
def test_collector_job(node):
    """The Job manifest per node: equal in both packages; names and
    labels within 63 characters, nodeName the raw name."""
    ref, port = both("k8s.node_collector")
    for kw in ({}, {"namespace": "ns", "image": "img:1",
                    "tolerations": [{"operator": "Exists"}]}):
        job = port.collector_job(node, **kw)
        assert job == ref.collector_job(node, **kw)
        assert len(job["metadata"]["name"]) <= 63
        assert len(job["metadata"]["labels"]["node"]) <= 63
        assert job["spec"]["template"]["spec"]["nodeName"] == node


@pytest.mark.parametrize("value", ["4h0m0s", "0", "0s", ""])
def test_streaming_timeout_values(value):
    ref, port = both("k8s.node_collector")
    doc = {"nodeName": "n", "info": {
        "kubeletStreamingConnectionIdleTimeoutArgumentSet":
            {"values": [value]}}}
    assert findings(port.assess_node_info(doc)) == \
        findings(ref.assess_node_info(doc))


class FakeCollectorClient:
    """A fake KubeClient for the collector's flow. `mode` "succeeds":
    the first poll finds the pod Succeeded; "retried": the first finds
    it Failed, the second the retry's pod Succeeded beside it;
    "both-fail": the retry's pod Failed too."""

    def __init__(self, mode: str = "succeeds"):
        self.mode = mode
        self.polls = 0
        self.posted: list = []
        self.deleted: list = []

    def post(self, path, body):
        self.posted.append((path, body))
        return body

    def list(self, kind, namespace="", selector=""):
        if kind == "Node":
            return [{"metadata": {"name": "worker-1"}}]
        self.polls += 1
        ok = {"metadata": {"name": "ok"}, "status": {"phase": "Succeeded"}}
        if self.mode == "succeeds":
            return [ok]
        pods = [{"metadata": {"name": "p1"}, "status": {"phase": "Failed"}}]
        if self.polls > 1:
            pods.append(ok if self.mode == "retried" else
                        {"metadata": {"name": "p2"},
                         "status": {"phase": "Failed"}})
        return pods

    def pod_logs(self, namespace, pod):
        return json.dumps(NODE_INFO).encode()

    def delete(self, path):
        self.deleted.append(path)
        return {}


@pytest.mark.parametrize("mode", ["succeeds", "retried", "both-fail"])
def test_collect_node_info(mode):
    """Job create, pod poll, log read and clean-up against a fake
    client: a first Failed pod waits for the retry; two end it with
    None; the Job is deleted either way."""
    outs = []
    for pkg in PKGS:
        client = FakeCollectorClient(mode)
        doc = mod(pkg, "k8s.node_collector").collect_node_info(
            client, "worker-1", poll_s=0.001, timeout_s=5)
        outs.append((doc, client.posted, client.deleted, client.polls))
    assert outs[1] == outs[0]
    assert (outs[1][0] is None) == (mode == "both-fail")
    assert len(outs[1][2]) == 1


@pytest.mark.parametrize("phase", ["Succeeded", "Failed"])
def test_collector_against_the_stub_server(stub_server, tmp_path, phase):
    """tests/test_k8s_apiserver.py's lifecycle: the namespace ensured,
    the Job created, then deleted with background propagation."""
    server, state = stub_server
    state.pod_phase = phase
    outs = []
    for pkg in PKGS:
        client = mod(pkg, "k8s.client").KubeClient(
            config_path=_kubeconfig(tmp_path, server))
        n = len(state.requests)
        doc = mod(pkg, "k8s.node_collector").collect_node_info(
            client, "worker-1", timeout_s=2 if phase == "Succeeded" else 0.5,
            poll_s=0.01)
        outs.append((doc, [(m, p) for m, p, _a in state.requests[n:]
                           if m != "GET"], dict(state.jobs)))
    assert outs[1] == outs[0]
    assert (outs[1][0] is not None) == (phase == "Succeeded")
    assert outs[1][2] == {}
    assert any("propagationPolicy=Background" in p for m, p in outs[1][1]
               if m == "DELETE")


@pytest.mark.parametrize("disable", [False, True],
                         ids=["merged", "disabled"])
def test_live_scan_node_findings(monkeypatch, disable):
    """ClusterScanner's live path with an injected client factory:
    the collector's findings merged, or none and no client built with
    the collector disabled."""
    outs = []
    for pkg in PKGS:
        scanner_mod = mod(pkg, "k8s.scanner")
        monkeypatch.setattr(scanner_mod, "load_cluster", lambda **kw: [])
        factory = FakeCollectorClient
        if disable:
            def factory():
                raise AssertionError("must not build a client")
        sc = scanner_mod.ClusterScanner(
            scanners={"infra"}, kube_client_factory=factory,
            disable_node_collector=disable)
        outs.append(findings(sc.scan("cluster").infra))
    assert outs[1] == outs[0]
    assert bool(outs[1]) != disable


# -------------------------------------------- the port's own departures


def image_scan_argv(cluster, tar_dir: str, tmp) -> list[str]:
    return ["kubernetes", cluster["manifests"], "--quiet", "-f", "json",
            "--scanners", "vuln,misconfig", "--image-tar-dir", tar_dir,
            "--db-path", cluster["db"], "--cache-dir", str(tmp)]


def secret_count(doc) -> int:
    """The secrets anywhere in a report document (a cluster report
    nests each image's report)."""
    if isinstance(doc, dict):
        return len(doc.get("Secrets") or []) + sum(
            secret_count(v) for k, v in doc.items() if k != "Secrets")
    if isinstance(doc, list):
        return sum(secret_count(v) for v in doc)
    return 0


def screen_fault_argv(cluster, command: str, tmp) -> list[str]:
    """A scan whose secret analyzer screens at least one file: the
    cluster's image scans, one of its archives, or a tree holding a
    planted token."""
    if command == "kubernetes":
        return image_scan_argv(cluster, cluster["tar_dir"], tmp / "cache")
    flags = ["--quiet", "-f", "json", "--scanners", "vuln,secret",
             "--db-path", cluster["db"], "--cache-dir", str(tmp / "cache")]
    if command == "image":
        return ["image", "--input", str(cluster["root"] / "img1.tar"),
                *flags]
    tree = tmp / "tree"
    tree.mkdir()
    (tree / "deploy.txt").write_text(f"token ghp_{'q' * 36}\n")
    return ["fs", str(tree), *flags]


@pytest.mark.parametrize("kernel,command", [
    ("match", "kubernetes"), ("anchor", "kubernetes"), ("anchor", "image"),
    ("anchor", "fs")])
def test_device_error_ends_the_run(cluster, tmp_path, capsys, monkeypatch,
                                   kernel, command):
    """A device error in an image scan's match, or in the secret screen
    that runs inside the image or tree walk's post-analyzers, ends the
    scan with rc 1, no report and one error line: never a report
    without that image or its secrets. The reference warns and leaves
    the image out (its failure here a plain RuntimeError, as a failed
    kernel launch raises there). No blob without its secrets is cached:
    the next run on the same cache dir, fault-free, reports them."""
    from trivy_tpu.scanner import local as jax_local
    from trivy_tpu_torch.ops import secret_nfa
    from trivy_tpu_torch.scanner import local as port_local

    argv = [*screen_fault_argv(cluster, command, tmp_path), "--device",
            "cpu"]
    if kernel == "match":
        def jax_fail(self, *a, **kw):
            raise RuntimeError("device launch failed")

        monkeypatch.setattr(jax_local.LocalDriver, "scan", jax_fail)
        assert jax_main.main([*argv[:-3], str(tmp_path / "jcache")]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert not any(r.get("Vulnerabilities") for r in doc["Resources"])
        cls, name = port_local.LocalDriver, "scan"
        msg = "match kernel launch failed: CUDA error 700\n(second line)"
    else:
        force_device_screen(monkeypatch)
        cls, name = secret_nfa.AnchorMatcher, "dispatch_chunks"
        msg = "anchor kernel launch failed: CUDA error 700"
    orig = getattr(cls, name)
    failing, calls = [True], []

    def port_fail(self, *a, **kw):
        calls.append(failing[0])
        if failing[0]:
            raise DeviceError(msg)
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, name, port_fail)
    if command == "kubernetes":
        assert main(argv) == 1
        out, err = capsys.readouterr()
        assert err.splitlines() == [msg.replace("\n", " ")]
    else:
        # the scan commands' error line is a log line, which --quiet
        # silences; the secret lane's retry warns on a line of its own
        assert main([a for a in argv if a != "--quiet"]) == 1
        out, err = capsys.readouterr()
        assert len([ln for ln in err.splitlines()
                    if msg in ln and "\tWARNING\t" not in ln]) == 1
    assert out == "" and calls
    failing[0] = False
    assert main(argv) == 0
    doc = json.loads(capsys.readouterr().out)
    assert secret_count(doc) >= 1 and calls[-1] is False
    if kernel == "match":
        assert all(r.get("Vulnerabilities") for r in doc["Resources"]
                   if set(r["Images"]) & set(cluster["images"]))


def test_what_counts_as_a_device_error(tmp_path, monkeypatch):
    """`device.is_device_error`, which decides what ends a `kubernetes`
    run: a DeviceError (a kernel that cannot build or launch raises one)
    and torch's CUDA errors, not any other failure."""
    from trivy_tpu_torch.device import is_device_error
    from trivy_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(DeviceError, match="nvcc not found") as e:
        kernels._nvcc()
    assert is_device_error(e.value)
    assert is_device_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not is_device_error(RuntimeError("not a tar archive"))
    assert not is_device_error(ValueError("bad layer"))


def test_a_corrupt_tar_is_skipped(cluster, tmp_path, capsys):
    """Any other image-scan failure keeps the reference's warn-and-skip,
    in both packages alike."""
    tar_dir = tmp_path / "tars"
    tar_dir.mkdir()
    for name in os.listdir(cluster["tar_dir"]):
        os.symlink(os.path.join(cluster["tar_dir"], name), tar_dir / name)
    bad = sorted(os.listdir(tar_dir))[0]
    os.unlink(tar_dir / bad)
    (tar_dir / bad).write_bytes(b"not a tar archive")
    argv = image_scan_argv(cluster, str(tar_dir), tmp_path / "j")
    assert jax_main.main(argv) == 0
    want = capsys.readouterr().out
    argv = image_scan_argv(cluster, str(tar_dir), tmp_path / "p")
    assert main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    scanned = [v for r in json.loads(got)["Resources"]
               for v in r.get("Vulnerabilities", [])]
    assert len(scanned) == len(cluster["images"]) - 1


def test_vuln_without_a_card_fails_at_once(cluster, tmp_path, capsys,
                                           monkeypatch):
    """`kubernetes --scanners vuln` on the card by default: without one
    and without --device cpu / --no-tpu it fails before any work, naming
    CUDA. Without `vuln` no card is needed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(run, "_load_db", lambda args: calls.append(1))
    argv = [a for a in image_scan_argv(cluster, cluster["tar_dir"],
                                       tmp_path) if a != "--quiet"]
    assert main(argv) == 1
    err = capsys.readouterr().err
    assert "CUDA" in err and calls == []
    assert len([ln for ln in err.splitlines() if ln.strip()]) == 1
    assert main(["kubernetes", cluster["manifests"], "--quiet"]) == 0


def test_report_from_the_environment(cluster, tmp_path, capsys,
                                     monkeypatch):
    """TRIVY_TPU_REPORT=all is `kubernetes`'s --report, honoured as the
    reference does; a scan command reads it too (its --report is the
    compliance report's detail, unread without --compliance)."""
    monkeypatch.setenv("TRIVY_TPU_REPORT", "all")
    argv = ["kubernetes", cluster["manifests"], "--quiet"]
    assert jax_main.main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got == reference_out(cluster, "all", False, capsys)
    fs = ["fs", cluster["manifests"], "--quiet", "--scanners", "misconfig",
          "--format", "json"]
    assert jax_main.main(fs + ["--cache-dir", str(tmp_path / "j")]) == 0
    want = capsys.readouterr().out
    assert main(fs + ["--cache-dir", str(tmp_path / "p"), "--device",
                      "cpu"]) == 0
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("where", ["env", "config", "flag"])
def test_compliance_is_refused(cluster, tmp_path, capsys, monkeypatch,
                               where):
    """--compliance (ported; once refused) from the environment, the
    config file or the command line: the reference's compliance report,
    byte for byte."""
    argv = ["kubernetes", cluster["manifests"], "--quiet", "--format",
            "json"]
    if where == "env":
        monkeypatch.setenv("TRIVY_TPU_COMPLIANCE", "k8s-nsa-1.0")
    elif where == "config":
        cfg = tmp_path / "trivy-tpu.yaml"
        cfg.write_text("compliance: k8s-nsa-1.0\n")
        argv += ["--config", str(cfg)]
    else:
        argv += ["--compliance", "k8s-nsa-1.0"]
    # k8s-nsa-1.0 brings `vuln`: its image scans need a DB
    argv += ["--db-path", cluster["db"]]
    assert jax_main.main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["ID"] == "k8s-nsa-1.0"


def _parser_of(parser, name):
    import argparse

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


def _options(p) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices or ()), a.nargs, type(a).__name__)
            for a in p._actions if a.dest != "help"}


def test_parser_is_the_reference_less_compliance_plus_device():
    """The port's `kubernetes` parser is the reference's (--compliance
    and the global --generate-default-config included now) plus
    --device; K8S_UNPORTED is empty."""
    ref = _options(_parser_of(jax_main.build_parser(), "kubernetes"))
    port = _options(_parser_of(build_parser(), "kubernetes"))
    assert set(ref) - set(port) == set()
    assert set(port) - set(ref) == {"device"}
    assert {d: port[d] for d in ref if d in port} == \
        {d: ref[d] for d in ref if d in port}
    assert config.K8S_UNPORTED == {}
    parser = build_parser()
    assert _parser_of(parser, "k8s") is _parser_of(parser, "kubernetes")


def test_merged_defaults_equal_the_reference():
    """The config layer reads each option's default across every parser
    (the last one that has it): the port's order of parsers gives each
    of `kubernetes`' and the scan commands' options the reference's
    default (--scanners "vuln,secret", --report "summary")."""
    from trivy_tpu.cli import config as jax_config

    ref = jax_config._all_defaults(jax_main.build_parser())
    parser = build_parser()
    port = config._all_defaults(parser)
    for name in ("kubernetes", "fs", "sbom", "repo", "vm", "convert"):
        dests = set(_options(_parser_of(parser, name))) & set(ref)
        assert {d: port[d] for d in dests} == {d: ref[d] for d in dests}
    assert port["device"] is None


@pytest.mark.cuda
def test_k8s_image_scans_on_the_card(cluster, tmp_path, capsys,
                                     monkeypatch):
    """On the card: `kubernetes --scanners vuln,...` equals --no-tpu
    byte for byte, the match kernel and the anchor screen launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from trivy_tpu_torch.ops import match, secret_nfa

    monkeypatch.setenv("TRIVY_TPU_SECRET_PROBE", "0")
    m0, a0 = match.match_words.launches, secret_nfa.anchor_words.launches
    argv = k8s_argv(cluster, "json", True, tmp_path)
    assert main(argv) == 0
    on_card = capsys.readouterr().out
    assert match.match_words.launches > m0
    assert secret_nfa.anchor_words.launches > a0
    assert main([*argv, "--no-tpu"]) == 0
    assert capsys.readouterr().out == on_card
