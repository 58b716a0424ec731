"""Port parity, custom misconfiguration checks and ignore policies:
trivy_tpu_torch's `iac/rego.py` (the Rego subset: parser, evaluator and
its step budget, builtins), `iac/engine.py` (Python, YAML and Rego
checks, namespaces, deprecation, `--config-data`, bundle paths),
`policy/bundle.py` (the check bundle under `<cache>/policy/content`),
`result/policy.py` and `result/filter.py` (`--ignore-policy`), against
the JAX package's on the CPU at a small scale.

- Rego: every source and query of tests/test_rego.py's `TestLanguage`,
  inline, gives the same value or the same error in both packages, and
  so do the reference's ignore-policy and custom-policy shapes (written
  here: tests/test_rego.py reads them from a reference checkout).
- Loaders: each shape of tests/test_check_engine.py and test_rego.py's
  engine wiring gives the same `Check` fields and the same causes.
- Bundles: staleness and refresh from an in-process localhost
  registry, `skip_update`, a failed update keeping the cache, and a
  bundle's `.py` refused.
- CLI: `fs`, `rootfs`, `repo`, `image`, `vm` and `config` with the
  custom checks of `chip_smoke.py` phase 21 and a cached bundle in
  json, table and sarif; `sbom`, `fs` and `image` with `--ignore-policy`
  as `.rego`, `.yaml` and `.py`; a fleet scan whose journal records the
  policy; the report under two hash seeds. After every test the check
  engine of both packages is back at its default set.

The port scans with `--device cpu` (the kernels' plain versions), the
reference on its JAX engine on the CPU. The tolerance is exact
equality.
"""

from __future__ import annotations

import gzip
import hashlib
import importlib
import io
import json
import os
import subprocess
import sys
import tarfile
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import pytest
import test_fanal
import torch

import chip_smoke

FAKE_TIME = "2024-01-01T00:00:00+00:00"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MODULES = {
    "rego": "iac.rego", "engine": "iac.engine", "bundle": "policy.bundle",
    "policy": "result.policy", "oci": "db.oci", "cli": "cli.main",
    "run": "cli.run", "uuid": "utils.uuid", "misconf": "misconf.scanner",
    "dockerfile": "iac.parsers.dockerfile",
}


def _namespace(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root)
    for attr, mod in _MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.port = root == "trivy_tpu_torch"
    ns.name = "port" if ns.port else "ref"
    ns.device = ["--device", "cpu"] if ns.port else []
    return ns


REF = _namespace("trivy_tpu")
PORT = _namespace("trivy_tpu_torch")
PKGS = (REF, PORT)


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
def _default_engine(monkeypatch):
    """Each test starts with both packages' default check set, and a
    CLI scan leaves it so: the scan resets the engine in its finally."""
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    for P in PKGS:
        P.engine.reset()
        P.run._ENGINE_CACHE.clear()
    yield
    try:
        assert PORT.engine.active() is PORT.engine._default
    finally:
        for P in PKGS:
            P.engine.reset()
            P.run._ENGINE_CACHE.clear()


def same(fn, *args, **kw):
    """`fn(P, ...)` for the reference and the port; the observations
    must be equal. -> the port's."""
    got = {P.name: fn(P, *args, **kw) for P in PKGS}
    assert got["port"] == got["ref"]
    return got["port"]


def norm(v):
    """A Rego value in a form both packages' values compare in: a set
    as its members in insertion order."""
    if type(v).__name__ == "Set":
        return ("set", [norm(x) for x in v])
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    return v


# ------------------------------------------------------------------ Rego


REGO_CASES = {
    "partial_set_rule": ('package t\ndeny[m] { m := "bad" }',
                         "data.t.deny", [None]),
    "partial_set_multiple_bodies": ("""package t
deny[m] { m := "a" }
deny[m] { m := "b" }
deny[m] { 1 == 2; m := "never" }
""", "data.t.deny", [None]),
    "complete_rule_and_default": ("""package t
default allow = false
allow { input.x == 1 }
""", "data.t.allow", [{"x": 1}, {"x": 2}, {}]),
    "undefined_without_default": ("package t\nr { input.x == 1 }",
                                  "data.t.r", [{}]),
    "constant_rules": ("""package t
n := 4
s := {"a", "b"}
arr := [1, 2, 3]
obj := {"k": "v"}
""", ["data.t.n", "data.t.s", "data.t.arr", "data.t.obj"], [None]),
    "iteration_underscore": ("package t\ndeny[m] { m := input.items[_].name }\n",
                             "data.t.deny",
                             [{"items": [{"name": "a"}, {"name": "b"}]}]),
    "iteration_binds_index": (
        'package t\ndeny[m] { input.xs[i] == "hit"; m := i }\n',
        "data.t.deny", [{"xs": ["miss", "hit", "hit"]}]),
    "set_literal_membership_iteration": (
        'package t\nr { input.sev == {"LOW", "MEDIUM"}[_] }\n',
        "data.t.r", [{"sev": "LOW"}, {"sev": "HIGH"}]),
    "rule_value_chaining": ("""package t
v = x { x := input.a.b }
r { v == 10 }
""", "data.t.r", [{"a": {"b": 10}}, {}]),
    "not_on_undefined_and_false": ("""package t
r1 { not input.missing }
r2 { not input.flag }
""", ["data.t.r1", "data.t.r2"], [{}, {"flag": False}, {"flag": True}]),
    "set_comprehension_and_count": ("""package t
bad := {"x", "y"}
n := c { c := count({v | v := input.ids[_]; v == bad[_]}) }
""", "data.t.n", [{"ids": ["x", "z", "y", "x"]}, {"ids": []}, {}]),
    "array_and_object_comprehension": ("""package t
arr := [x * 2 | x := input.ns[_]]
obj := {k: v | some k, v in input.m}
""", ["data.t.arr", "data.t.obj"], [{"ns": [1, 2], "m": {"a": 1}}]),
    "functions": ("""package t
double(x) = y { y := x * 2 }
r := v { v := double(21) }
""", "data.t.r", [None]),
    "function_undefined_arg_fails_body": ("""package t
f(x) = y { y := x }
r { f(input.missing) == 1 }
""", "data.t.r", [{}]),
    "object_rule": ("package t\nport[name] = p { some name, p in input.svc }\n",
                    "data.t.port", [{"svc": {"http": 80}}]),
    "arithmetic_and_comparison": (
        "package t\nr { (input.a + 3) * 2 == 10; input.a < 3; input.a >= 2 }\n",
        "data.t.r", [{"a": 2}, {"a": 5}]),
    "division_by_zero_is_undefined": ("package t\nr { 1 / input.z == 1 }",
                                      "data.t.r", [{"z": 0}]),
    "in_operator": ("""package t
r1 { input.x in {"a", "b"} }
r2 { input.x in ["a", "b"] }
""", ["data.t.r1", "data.t.r2"], [{"x": "a"}, {"x": "b"}, {"x": "c"}]),
    "some_in": ("""package t
deny[m] { some item in input.xs; item.bad; m := item.name }
""", "data.t.deny", [{"xs": [{"name": "a", "bad": True},
                             {"name": "b", "bad": False}]}]),
    "rego_v1_forms": ("""package t
import rego.v1
default ignore := false
allowed := {"X-1"}
ok if input.id in allowed
ignore if not ok
deny contains m if { m := "boom"; input.fail }
""", ["data.t.ignore", "data.t.deny"],
        [{"id": "X-1"}, {"id": "Y"}, {"fail": True}, {}]),
    "unify_binds": ("package t\nr := x { x = input.v }\n", "data.t.r",
                    [{"v": 7}]),
    "builtins": ("""package t
r1 := v { v := sprintf("%s has %d", ["pkg", 3]) }
r2 { startswith(input.s, "ab"); endswith(input.s, "yz") }
r3 := v { v := concat(",", sort({"b", "a"})) }
r4 := v { v := to_number(input.n) }
r5 { regex.match("^v[0-9]+", input.tag) }
""", ["data.t.r1", "data.t.r2", "data.t.r3", "data.t.r4", "data.t.r5"],
        [{"s": "ab..yz", "n": "12", "tag": "v12"}]),
    "go_sprintf_verbs": ("""package t
v := sprintf("%v|%d|%s|%q|%v|%v|%v|%v|%v|%%", [
    1.5, 7, "s", "q\\"x", {"b", "a"}, {"k": [1, true, null]}, 3, 2.0,
    ["x", 1]])
""", "data.t.v", [None]),
    "sort_and_set_order": ("""package t
s := sort([3, 1, 2])
t := sort({"b", "c", "a"})
u := {x | x := input.xs[_]}
""", ["data.t.s", "data.t.t", "data.t.u"],
        [{"xs": [3, "a", 1, {"k": 1}, [2], True, None, 1]}]),
    "cvss_vector": ("""package t
import data.lib.trivy
v := trivy.parse_cvss_vector_v3(input.vec)
""", "data.t.v", [{"vec": "CVSS:3.1/AV:L/AC:H/PR:H/UI:R/S:C/C:H/I:L/A:N"},
                  {"vec": "garbage"}]),
    "data_documents": ("package t\nr { input.name == data.allowed[_] }\n",
                       "data.t.r", [{"name": "x"}, {"name": "z"}]),
    "evaluation_cycle": ("package t\na { b }\nb { a }\n", "data.t.a",
                         [None]),
    "evaluation_budget": (
        "package t\nn := count([1 | input.xs[_]; input.xs[_]; "
        "input.xs[_]])\n", "data.t.n", [{"xs": list(range(130))}]),
}


def rego_outcomes(P, src, queries, inputs, data=None):
    if isinstance(queries, str):
        queries = [queries]
    out = []
    try:
        mod = P.rego.parse_module(src)
    except P.rego.RegoError as e:
        return [("parse error", str(e))]
    for inp in inputs:
        for q in queries:
            try:
                out.append(norm(P.rego.Evaluator([mod], input=inp,
                                                 data=data).query(q)))
            except P.rego.RegoError as e:
                out.append(("error", str(e)))
    return out


@pytest.mark.parametrize("case", sorted(REGO_CASES))
def test_rego_language_equals_reference(case):
    src, queries, inputs = REGO_CASES[case]
    data = {"allowed": ["x", "y"]} if case == "data_documents" else None
    got = same(rego_outcomes, src, queries, inputs, data)
    if case == "evaluation_budget":
        assert got == [("error", "evaluation budget exceeded")]
    if case == "partial_set_multiple_bodies":
        assert got == [("set", ["a", "b"])]


@pytest.mark.parametrize("src", [
    "package t\nr { x := 1 } else = false { true }",
    "package t\nr { every x in [1] { x > 0 } }",
    "package t\nr { x := 1 } with input as {}",
    "package t.\nr := 1",
    "package t\nr { input.x ==  }",
])
def test_rego_unsupported_constructs_raise_the_same(src):
    got = same(rego_outcomes, src, "data.t.r", [None])
    assert got[0][0] in ("parse error", "error")


def test_rego_cross_module_import():
    lib = "package lib.util\nis_big(x) { x > 10 }\n"
    main = "package t\nimport data.lib.util\nr { util.is_big(input.n) }\n"

    def run(P, n):
        ev = P.rego.Evaluator([P.rego.parse_module(lib),
                               P.rego.parse_module(main)], input={"n": n})
        return ev.query("data.t.r")

    assert same(lambda P: [run(P, 11), run(P, 3)]) == [True, None]


# the reference's ignore-policy examples (examples/ignore-policies/) and
# its custom-policy fixture (integration/testdata/fixtures/repo/
# custom-policy/policy), in their shapes
IGNORE_BASIC = """package trivy

import data.lib.trivy

default ignore = false

ignore_pkgs := {"bash", "bind-license", "rpm", "vim", "vim-minimal"}

ignore_severities := {"LOW", "MEDIUM"}

nvd_v3_vector = v {
    v := input.CVSS.nvd.V3Vector
}

redhat_v3_vector = v {
    v := input.CVSS.redhat.V3Vector
}

ignore {
    input.PkgName == ignore_pkgs[_]
}

ignore {
    input.Severity == ignore_severities[_]
}

# Ignore a vulnerability which is not remotely exploitable
ignore {
    nvd_cvss_vector := trivy.parse_cvss_vector_v3(nvd_v3_vector)
    nvd_cvss_vector.AttackVector != "Network"

    redhat_cvss_vector := trivy.parse_cvss_vector_v3(redhat_v3_vector)
    redhat_cvss_vector.AttackVector != "Network"
}

# Ignore CSRF
ignore {
    input.CweIDs[_] == "CWE-352"
}

# Ignore the masked AWS access key of a test fixture
ignore {
    input.RuleID == "aws-access-key-id"
    input.Match == `AWS_ACCESS_KEY_ID="********************"`
}
"""
IGNORE_ADVANCED = """package trivy

import data.lib.trivy

default ignore = false

nvd_v3_vector = v {
    v := input.CVSS.nvd.V3Vector
}

redhat_v3_vector = v {
    v := input.CVSS.redhat.V3Vector
}

# Ignore a vulnerability which requires high privilege
ignore {
    nvd_cvss_vector := trivy.parse_cvss_vector_v3(nvd_v3_vector)
    nvd_cvss_vector.PrivilegesRequired == "High"

    redhat_cvss_vector := trivy.parse_cvss_vector_v3(redhat_v3_vector)
    redhat_cvss_vector.PrivilegesRequired == "High"
}

# Ignore a vulnerability which requires user interaction
ignore {
    nvd_cvss_vector := trivy.parse_cvss_vector_v3(nvd_v3_vector)
    nvd_cvss_vector.UserInteraction == "Required"

    redhat_cvss_vector := trivy.parse_cvss_vector_v3(redhat_v3_vector)
    redhat_cvss_vector.UserInteraction == "Required"
}

ignore {
    input.PkgName == "openssl"

    # Evaluate severity
    input.Severity == {"LOW", "MEDIUM", "HIGH"}[_]

    # Evaluate CWE-ID
    deny_cwe_ids := {
        "CWE-119", # Improper Restriction of Operations within the Bounds
        "CWE-200", # Exposure of Sensitive Information
    }
    count({x | x := input.CweIDs[_]; x == deny_cwe_ids[_]}) == 0
}
"""
IGNORE_WHITELIST = """package trivy

import rego.v1

default ignore := true

allowed_misconfigs := {"AVD-AWS-0089"}

ignore := false if input.AVDID in allowed_misconfigs
"""
LOCAL = "CVSS:3.1/AV:L/AC:L/PR:N/UI:N/S:U/C:H/I:H/A:H"
NET = "CVSS:3.1/AV:N/AC:L/PR:N/UI:N/S:U/C:H/I:H/A:H"
HI_PRIV = "CVSS:3.1/AV:N/AC:L/PR:H/UI:N/S:U/C:H/I:H/A:H"
IGNORE_CASES = {
    "basic": (IGNORE_BASIC, [
        {"PkgName": "bash"}, {"PkgName": "x", "Severity": "LOW"},
        {"PkgName": "x", "Severity": "HIGH"},
        {"PkgName": "x", "Severity": "HIGH", "CVSS": {
            "nvd": {"V3Vector": LOCAL}, "redhat": {"V3Vector": LOCAL}}},
        {"PkgName": "x", "Severity": "HIGH", "CVSS": {
            "nvd": {"V3Vector": NET}, "redhat": {"V3Vector": NET}}},
        {"Severity": "HIGH", "CweIDs": ["CWE-352"]},
        {"RuleID": "aws-access-key-id",
         "Match": 'AWS_ACCESS_KEY_ID="********************"'}]),
    "advanced": (IGNORE_ADVANCED, [
        {"CVSS": {"nvd": {"V3Vector": HI_PRIV},
                  "redhat": {"V3Vector": HI_PRIV}}},
        {"CVSS": {"nvd": {"V3Vector": NET}, "redhat": {"V3Vector": NET}}},
        {"PkgName": "openssl", "Severity": "LOW", "CweIDs": ["CWE-999"]},
        {"PkgName": "openssl", "Severity": "LOW", "CweIDs": ["CWE-119"]}]),
    "whitelist": (IGNORE_WHITELIST, [{"AVDID": "AVD-AWS-0089"},
                                     {"AVDID": "AVD-AWS-0042"}]),
}
IGNORE_WANT = {
    "basic": [True, True, False, True, False, True, True],
    "advanced": [True, False, True, False],
    "whitelist": [False, True],
}


@pytest.mark.parametrize("case", sorted(IGNORE_CASES))
def test_reference_ignore_policy_shapes(tmp_path, case):
    src, findings = IGNORE_CASES[case]
    path = tmp_path / f"{case}.rego"
    path.write_text(src)

    def run(P):
        pol = P.policy.load_ignore_policy(str(path))
        return [pol.ignored(f) for f in findings]

    assert same(run) == IGNORE_WANT[case]


def test_reference_custom_policy_modules(tmp_path):
    """Rego modules without metadata: id "N/A", severity UNKNOWN, every
    input type, their package as the namespace."""
    (tmp_path / "foo.rego").write_text(
        'package user.foo\n\ndeny[msg] {\n    input.foo == "bar"\n'
        '    msg := "foo is bar"\n}\n')
    (tmp_path / "bar.rego").write_text(
        'package user.bar\n\ndeny[msg] {\n    input.bar == "baz"\n'
        '    msg := sprintf("bar is %s", [input.bar])\n}\n')

    def run(P):
        checks = P.rego.load_rego_checks([str(tmp_path / "foo.rego"),
                                          str(tmp_path / "bar.rego")])
        return [check_fields(c) for c in checks]

    got = same(run)
    assert {c[10] for c in got} == {"user.foo", "user.bar"}
    assert all(c[0] == "N/A" and c[5] == "UNKNOWN" for c in got)


# ---------------------------------------------------------------- loaders


def check_fields(c) -> tuple:
    return (c.id, c.avd_id, c.title, c.description, c.resolution,
            c.severity, tuple(c.file_types), c.provider, c.service, c.url,
            c.namespace, c.deprecated)


K8S_BAD = b"""\
apiVersion: v1
kind: Pod
metadata:
  name: badpod
spec:
  hostNetwork: true
  containers:
    - name: app
      image: nginx
      securityContext:
        privileged: true
"""
K8S_GOOD = b"""\
apiVersion: v1
kind: Pod
metadata:
  name: goodpod
spec:
  containers:
    - name: app
      image: nginx
      securityContext:
        runAsNonRoot: true
        privileged: false
"""
YAML_CHECK = """\
id: USR-001
title: hostNetwork must not be used
severity: HIGH
type: kubernetes
deny:
  - path: spec.hostNetwork
    equals: true
    message: pod uses hostNetwork
"""
PY_CHECK = '''\
__check__ = {
    "id": "USR-100",
    "title": "images must come from corp registry",
    "severity": "CRITICAL",
    "type": "kubernetes",
    "namespace": "user.registry",
}

def deny(input, data=None):
    allowed = (data or {}).get("allowed_registries", ["corp.example"])
    out = []
    for c in (input.get("spec", {}).get("containers") or []):
        image = c.get("image", "")
        if not any(image.startswith(r + "/") for r in allowed):
            out.append({"message": f"image {image} not from corp registry"})
    return out
'''
OPS_CHECK = """\
id: USR-OPS
title: ops
type: kubernetes
deny:
  - all:
      - path: kind
        equals: Pod
      - path: spec.containers[*].image
        regex: "^nginx"
      - not:
          path: spec.containers[*].securityContext.runAsNonRoot
          equals: true
    message: nginx must run non-root
"""
DF_CHECK = """\
id: USR-DF1
title: no curl-pipe-sh
type: dockerfile
severity: CRITICAL
deny:
  - path: Stages[*].Commands[*].Value[*]
    regex: "curl[^|]*\\\\|\\\\s*sh"
    message: curl | sh detected
"""
TF_CHECK = """\
id: USR-TF1
title: buckets must be tagged
type: cloud
deny:
  - all:
      - path: Resources[*].Type
        equals: s3_bucket
      - not:
          path: Resources[*].Values.tags
          exists: true
    message: s3 bucket without tags
"""
REGO_LIB = "package lib.ports\nbad := {22, 23}\n"
REGO_CHECK = """# METADATA
# title: no telnet
# custom:
#   id: USR-100
#   severity: HIGH
#   input:
#     selector:
#     - type: kubernetes
package user.telnet

import data.lib.ports

deny[msg] {
    input.spec.ports[_] == ports.bad[_]
    msg := "bad port exposed"
}
"""
LEGACY_CHECK = """package user.legacy
__rego_metadata__ := {
    "id": "USR-200",
    "title": "legacy title",
    "severity": "LOW",
}
deny[m] { m := "x" }
"""


def scan_ids(P, content, path="pod.yaml"):
    m = P.misconf.scan_config(path, content)
    if m is None:
        return None
    return ([(f.id, f.message, f.severity, f.namespace,
              f.cause_metadata.resource) for f in m.failures],
            sorted(s.id for s in m.successes))


def files(tmp_path, tree: dict) -> None:
    for rel, body in tree.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(body)


def _dsl_fails_and_passes(P, tmp):
    files(tmp, {"checks/hostnet.yaml": YAML_CHECK})
    P.engine.configure(check_paths=[str(tmp / "checks")],
                       namespaces=["user"])
    return [scan_ids(P, K8S_BAD), scan_ids(P, K8S_GOOD)]


def _namespace_gating(P, tmp):
    files(tmp, {"checks/hostnet.yaml": YAML_CHECK})
    P.engine.configure(check_paths=[str(tmp / "checks")])
    return scan_ids(P, K8S_BAD)


def _operators(P, tmp):
    files(tmp, {"c/ops.yaml": OPS_CHECK})
    P.engine.configure(check_paths=[str(tmp / "c")], namespaces=["user"])
    return [scan_ids(P, K8S_BAD), scan_ids(P, K8S_GOOD)]


def _load_error(body):
    def shape(P, tmp):
        files(tmp, {"bad.yaml" if "def " not in body else "bad.py": body})
        name = "bad.py" if "def " in body else "bad.yaml"
        try:
            P.engine.load_check_path(str(tmp / name))
        except P.engine.CheckLoadError as e:
            return str(e).replace(str(tmp), "T")
        return "loaded"
    return shape


def _python_with_data(P, tmp):
    files(tmp, {"checks/registry.py": PY_CHECK,
                "data/registries.yaml": "allowed_registries: "
                                        "[registry.corp]\n"})
    P.engine.configure(check_paths=[str(tmp / "checks")],
                       namespaces=["user"], data_paths=[str(tmp / "data")])
    ok = K8S_GOOD.replace(b"image: nginx", b"image: registry.corp/nginx")
    return [scan_ids(P, K8S_BAD), scan_ids(P, ok)]


def _deprecated(P, tmp):
    files(tmp, {"checks/old.yaml": YAML_CHECK + "deprecated: true\n"})
    P.engine.configure(check_paths=[str(tmp / "checks")],
                       namespaces=["user"])
    off = scan_ids(P, K8S_BAD)
    P.engine.configure(check_paths=[str(tmp / "checks")],
                       namespaces=["user"], include_deprecated=True)
    return [off, scan_ids(P, K8S_BAD)]


def _dockerfile_check(P, tmp):
    files(tmp, {"c/df.yaml": DF_CHECK})
    P.engine.configure(check_paths=[str(tmp / "c")], namespaces=["user"])
    return [scan_ids(P, b"FROM alpine\nRUN curl http://x.sh | sh\n",
                     "Dockerfile"),
            scan_ids(P, b"FROM alpine\nRUN apk add --no-cache curl\n"
                        b"USER app\n", "Dockerfile")]


def _dockerfile_input_doc(P, tmp):
    df = P.dockerfile.parse_dockerfile(
        b"FROM alpine AS base\nRUN echo hi\nHEALTHCHECK CMD [\"x\"]\n"
        b"COPY --chown=a:b . /app\n")
    return P.engine.input_doc(P.misconf.DockerfileCtx(path="Dockerfile",
                                                      dockerfile=df))


def _terraform_check(P, tmp):
    files(tmp, {"c/tf.yaml": TF_CHECK})
    P.engine.configure(check_paths=[str(tmp / "c")], namespaces=["user"])
    return scan_ids(P, b'resource "aws_s3_bucket" "b" {\n  bucket = "x"\n'
                       b'}\n', "main.tf")


def _rego_dir_with_library(P, tmp):
    files(tmp, {"lib.rego": REGO_LIB, "chk.rego": REGO_CHECK})
    checks = P.engine.load_check_path(str(tmp))

    class K8sCtx:  # matches engine.input_doc dispatch
        resource = {"spec": {"ports": [80, 23]}}

    return [(check_fields(c), [x.message for x in c.fn(K8sCtx())])
            for c in checks]


def _rego_in_data_only_bundle(P, tmp):
    files(tmp, {"p.rego": 'package user.x\ndeny[m] { m := "hit" }\n',
                "evil.py": "raise SystemExit(1)\n"})
    return [check_fields(c) for c in
            P.engine.load_check_path(str(tmp), allow_python=False)]


def _legacy_metadata(P, tmp):
    files(tmp, {"m.rego": LEGACY_CHECK})
    return [check_fields(c) for c in P.engine.load_check_path(str(tmp))]


def _bundle_python_refused(P, tmp):
    files(tmp, {"bundle/evil.py": (
        "import sys\nsys.BUNDLE_PWNED = True\n"
        "__check__ = {'id': 'X', 'title': 't', 'type': 'kubernetes'}\n"
        "def deny(input): return []\n"), "bundle/ok.yaml": YAML_CHECK})
    cs = P.engine.CheckSet(bundle_paths=[str(tmp / "bundle")],
                           namespaces=["user"])
    return [hasattr(sys, "BUNDLE_PWNED"), [c.id for c in cs.user_checks]]


def _phase21_set(P, tmp):
    """chip_smoke.py phase 21's checks: every field, and the data."""
    paths = chip_smoke.write_custom_checks(str(tmp))
    cs = P.engine.configure(check_paths=[paths["checks"]],
                            namespaces=["user"],
                            data_paths=[paths["data"]],
                            bundle_paths=[os.path.join(
                                paths["cache"], "policy", "content")])
    return [check_fields(c) for c in cs.user_checks]


def _resolve_paths(P, tmp):
    doc = {"spec": {"containers": [
        {"name": "a", "ports": [{"port": 80}, {"port": 443}]},
        {"name": "b"}], "hostNetwork": True}}
    return [P.engine.resolve_path(doc, p) for p in (
        "spec.hostNetwork", "spec.containers[*].name",
        "spec.containers[*].ports[*].port", "spec.containers[1].name",
        "spec.nope.deep", "spec.containers[9].name")]


LOADER_SHAPES = {
    "resolve_path": _resolve_paths,
    "dsl_fails_and_passes": _dsl_fails_and_passes,
    "namespace_gating": _namespace_gating,
    "operators": _operators,
    "bad_check_rejected": _load_error(
        "id: X\ntitle: t\ntype: kubernetes\ndeny:\n  - path: a.b\n"),
    "unknown_type_rejected": _load_error(
        "id: X\ntitle: t\ntype: nonsense\ndeny: []\n"),
    "broken_python_check": _load_error("def deny(i): return []\n"),
    "python_check_with_data": _python_with_data,
    "deprecated_skipped_by_default": _deprecated,
    "dockerfile_check": _dockerfile_check,
    "dockerfile_input_doc": _dockerfile_input_doc,
    "terraform_user_check": _terraform_check,
    "rego_dir_with_library": _rego_dir_with_library,
    "rego_in_data_only_bundle": _rego_in_data_only_bundle,
    "legacy_rego_metadata": _legacy_metadata,
    "bundle_python_refused": _bundle_python_refused,
    "phase21_check_set": _phase21_set,
}


@pytest.mark.parametrize("shape", sorted(LOADER_SHAPES))
def test_check_loaders_equal_reference(tmp_path, shape):
    """Each engine shape in both packages, each on a directory of its
    own: the same Check fields, causes and load errors."""
    got = {}
    for P in PKGS:
        d = tmp_path / P.name
        d.mkdir()
        try:
            got[P.name] = LOADER_SHAPES[shape](P, d)
        finally:
            P.engine.reset()
    assert got["port"] == got["ref"]
    if shape == "bundle_python_refused":
        assert got["port"] == [False, ["USR-001"]]
    if shape == "phase21_check_set":
        ids = [f[0] for f in got["port"]]
        assert chip_smoke.IAC_BUNDLE_REFUSED not in ids
        assert sorted(ids) == sorted(chip_smoke.IAC_CUSTOM_IDS)


# ---------------------------------------------------------------- bundles


class _Registry(BaseHTTPRequestHandler):
    """An OCI registry on localhost serving one artifact: the manifest
    and its one layer. `requests` counts manifest fetches."""

    blobs: dict = {}
    manifest = b""
    requests: list = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        if "/manifests/" in self.path:
            type(self).requests.append(self.path)
            body, ctype = self.manifest, \
                "application/vnd.oci.image.manifest.v1+json"
        else:
            body = self.blobs.get(self.path.rsplit("/", 1)[1])
            ctype = "application/octet-stream"
        if body is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def bundle_layer(entries) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, body in entries:
            data = body.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return gzip.compress(buf.getvalue(), mtime=0)


@pytest.fixture()
def registry():
    data = bundle_layer(chip_smoke.IAC_BUNDLE)
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    _Registry.blobs = {digest: data}
    _Registry.requests = []
    _Registry.manifest = json.dumps({
        "schemaVersion": 2, "config": {"digest": "sha256:" + "0" * 64},
        "layers": [{"mediaType": "application/vnd.cncf.openpolicyagent."
                                 "layer.v1.tar+gzip",
                    "digest": digest, "size": len(data)}]}).encode()
    srv = HTTPServer(("127.0.0.1", 0), _Registry)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"127.0.0.1:{srv.server_address[1]}/checks:1"
    finally:
        srv.shutdown()
        srv.server_close()


def _bundle_lifecycle(P, cache, ref):
    b = P.bundle
    out = [b.bundle_check_paths(cache) == []]
    n0 = len(_Registry.requests)
    paths = b.bundle_check_paths(cache, repository=ref, insecure=True)
    out.append(len(_Registry.requests) - n0)
    out.append(sorted(os.listdir(paths[0])))
    out.append([check_fields(c) for c in
                P.engine.load_check_path(paths[0], allow_python=False)])
    # fresh metadata: no second download
    b.bundle_check_paths(cache, repository=ref, insecure=True)
    out.append(len(_Registry.requests) - n0)
    meta = b._metadata_path(cache)
    with open(meta) as f:
        doc = json.load(f)
    out.append(doc["repository"])
    doc["downloaded_at"] -= b.UPDATE_INTERVAL_S + 1
    with open(meta, "w") as f:
        json.dump(doc, f)
    # skip_update honours the flag even when stale
    b.bundle_check_paths(cache, repository=ref, skip_update=True,
                         insecure=True)
    out.append(len(_Registry.requests) - n0)
    # stale: refreshed
    b.bundle_check_paths(cache, repository=ref, insecure=True)
    out.append(len(_Registry.requests) - n0)
    return out


def test_bundle_staleness_and_refresh_from_a_local_registry(registry,
                                                            tmp_path):
    got = {}
    for P in PKGS:
        got[P.name] = _bundle_lifecycle(P, str(tmp_path / P.name), registry)
    assert got["port"] == got["ref"]
    assert got["port"][1] == 1 and got["port"][4] == 1
    assert got["port"][6] == 1 and got["port"][7] == 2


@pytest.mark.parametrize("ref", ["127.0.0.1:1/checks:1", "registry"])
def test_failed_bundle_update_keeps_the_cache(registry, tmp_path, ref):
    """An update that fails (nothing listens on port 1; or the
    registry answers over plain HTTP to an https client) is not fatal:
    the cached bundle stays and is used."""
    ref = registry if ref == "registry" else ref

    def run(P):
        cache = str(tmp_path / P.name)
        content = chip_smoke.place_bundle(cache)
        paths = P.bundle.bundle_check_paths(cache, repository=ref)
        return [p == content for p in paths], sorted(os.listdir(content))

    got = same(run)
    assert got[0] == [True]


# -------------------------------------------------------------------- CLI


LOCKFILES = [("app/package-lock.json", test_fanal.PACKAGE_LOCK),
             ("app/requirements.txt", test_fanal.REQUIREMENTS)]
POLICIES = {
    "rego": ("ignore.rego", """package trivy

default ignore = false

ignore {
    input.PkgName == "requests"
}

ignore {
    input.AVDID == "AVD-DS-0026"
}

ignore {
    input.RuleID == "aws-access-key-id"
}
"""),
    "yaml": ("ignore.yaml", """ignore:
  - path: PkgName
    equals: requests
  - path: AVDID
    equals: AVD-DS-0026
  - path: RuleID
    equals: aws-access-key-id
"""),
    "py": ("ignore.py", """def ignore(finding):
    return (finding.get("PkgName") == "requests"
            or finding.get("AVDID") == "AVD-DS-0026"
            or finding.get("RuleID") == "aws-access-key-id")
"""),
}
SBOM_DOC = {
    "bomFormat": "CycloneDX", "specVersion": "1.5", "version": 1,
    "metadata": {"component": {"type": "application", "name": "app",
                               "bom-ref": "app"}},
    "components": [
        {"type": "library", "name": "lodash", "version": "4.17.4",
         "purl": "pkg:npm/lodash@4.17.4", "bom-ref": "pkg:npm/lodash@4.17.4"},
        {"type": "library", "name": "requests", "version": "2.19.0",
         "purl": "pkg:pypi/requests@2.19.0",
         "bom-ref": "pkg:pypi/requests@2.19.0"}]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A two-service monorepo of chip_smoke.iac_monorepo (no check
    fixtures) with test_fanal's lockfiles, an alpine root and a leaked
    key; the fixture DB saved; phase 21's checks, data and bundle; the
    three policies; the tree as a docker-save archive and an ext4 disk;
    an SBOM of the lockfiles' packages."""
    tmp = tmp_path_factory.mktemp("policy")
    tree = tmp / "tree"
    chip_smoke.iac_monorepo(str(tree), 2, LOCKFILES, conformance=False)
    chip_smoke.write_files(str(tree), [
        ("etc/os-release", test_fanal.OS_RELEASE),
        ("lib/apk/db/installed", test_fanal.APK_INSTALLED),
        ("app/.env", test_fanal.SECRET_FILE)])
    test_fanal._fixture_db().save(str(tmp / "db"))
    custom = chip_smoke.write_custom_checks(str(tmp / "custom"))
    for name, body in POLICIES.values():
        (tmp / name).write_text(body)
    (tmp / "bom.json").write_text(json.dumps(SBOM_DOC))
    members = []
    for d, _dirs, names in os.walk(tree):
        for n in sorted(names):
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                members.append((os.path.relpath(p, tree), f.read()))
    tar = str(tmp / "image.tar")
    chip_smoke.write_image(tar, [chip_smoke.layer_tar(sorted(members))],
                           [{"created_by": "COPY . /"}], "docker")
    disk = None
    mkfs = [p for p in ("/usr/sbin/mkfs.ext4", "/sbin/mkfs.ext4")
            if os.path.exists(p)]
    if mkfs:
        disk = str(tmp / "disk.raw")
        subprocess.run([mkfs[0], "-q", "-F", "-d", str(tree), disk, "16m"],
                       check=True, capture_output=True)
    return {"tree": str(tree), "db": str(tmp / "db"), "custom": custom,
            "tar": tar, "disk": disk, "sbom": str(tmp / "bom.json"),
            "tmp": tmp}


def target_argv(corpus, cmd) -> list[str]:
    if cmd == "image":
        return ["image", "--input", corpus["tar"]]
    if cmd == "vm":
        return ["vm", corpus["disk"]]
    if cmd == "sbom":
        return ["sbom", corpus["sbom"]]
    return [cmd, corpus["tree"]]


def both(argv, tmp_path, capsys, cache_of=None) -> tuple:
    """(rc, stdout) of each package's CLI, on a cache directory of its
    own (`cache_of(P)`, or a fresh one)."""
    got = {}
    for P in PKGS:
        cache = cache_of(P) if cache_of else str(tmp_path / f"c-{P.name}")
        P.uuid.reset()
        rc = P.cli.main(argv + ["--cache-dir", cache] + P.device)
        got[P.name] = (rc, capsys.readouterr().out)
    return got["ref"], got["port"]


def failed_ids(out: str) -> set:
    doc = json.loads(out)
    return {m["ID"] for r in doc.get("Results") or []
            for m in r.get("Misconfigurations") or []
            if m["Status"] == "FAIL"}


@pytest.mark.parametrize("fmt", ["json", "table", "sarif"])
@pytest.mark.parametrize("cmd", ["fs", "rootfs", "repo", "image", "vm",
                                 "config"])
def test_custom_checks_cli_equals_reference(corpus, tmp_path, capsys, cmd,
                                            fmt):
    """Each scan command with phase 21's checks, data, namespaces,
    deprecated checks and a cached bundle (refreshed never:
    --skip-check-update): the reference's bytes in each format."""
    if cmd == "vm" and corpus["disk"] is None:
        pytest.skip("needs mkfs.ext4 to build the disk image")
    custom = corpus["custom"]
    argv = [*target_argv(corpus, cmd), "--format", fmt, "--quiet",
            "--db-path", corpus["db"], "--config-check", custom["checks"],
            "--config-data", custom["data"], "--check-namespaces", "user",
            "--include-deprecated-checks", "--skip-check-update"]
    if cmd != "config":
        argv += ["--scanners", "vuln,secret,misconfig"]

    def cache_of(P):
        cache = str(tmp_path / f"c-{P.name}")
        chip_smoke.place_bundle(cache)
        return cache

    want, got = both(argv, tmp_path, capsys, cache_of)
    assert got == want and want[0] == 0
    if fmt == "json":
        ids = failed_ids(got[1])
        assert chip_smoke.IAC_BUNDLE_REFUSED not in ids
        assert {"USR-DEP-001", "USR-BUNDLE-001", "USR-K8S-001"} <= ids


def test_custom_checks_need_their_flags(corpus, tmp_path, capsys):
    """Without --check-namespaces no user check runs, and without
    --include-deprecated-checks the deprecated one does not: in both
    packages alike."""
    custom = corpus["custom"]
    base = ["config", corpus["tree"], "--format", "json", "--quiet",
            "--config-check", custom["checks"], "--config-data",
            custom["data"]]
    want, got = both(base, tmp_path, capsys)
    assert got == want and not {i for i in failed_ids(got[1])
                                if i.startswith("USR-")}
    want, got = both(base + ["--check-namespaces", "user"], tmp_path,
                     capsys)
    ids = failed_ids(got[1])
    assert got == want and "USR-PY-001" in ids and "USR-DEP-001" not in ids


def test_a_bad_check_path_is_one_error_line(corpus, tmp_path, capsys):
    (tmp_path / "bad.yaml").write_text(
        "id: X\ntitle: t\ntype: nonsense\ndeny: []\n")
    errs = {}
    for P in PKGS:
        assert P.cli.main(["config", corpus["tree"], "--config-check",
                           str(tmp_path / "bad.yaml"), "--cache-dir",
                           str(tmp_path / P.name)] + P.device) == 1
        captured = capsys.readouterr()
        lines = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
        assert captured.out == "" and len(lines) == 1
        errs[P.name] = lines[0].split("ERROR", 1)[1]
    assert errs["port"] == errs["ref"] and "loading checks" in errs["port"]


@pytest.mark.parametrize("form", sorted(POLICIES))
@pytest.mark.parametrize("cmd", ["sbom", "fs", "image"])
def test_ignore_policy_cli_equals_reference(corpus, tmp_path, capsys, cmd,
                                            form):
    """`--ignore-policy` as Rego, YAML and Python: the reference's
    report, and it drops some findings of each kind but not all."""
    scanners = "vuln" if cmd == "sbom" else "vuln,secret,misconfig"
    argv = [*target_argv(corpus, cmd), "--format", "json", "--quiet",
            "--db-path", corpus["db"], "--scanners", scanners]
    policy = str(corpus["tmp"] / POLICIES[form][0])
    want, got = both(argv + ["--ignore-policy", policy], tmp_path, capsys)
    assert got == want and want[0] == 0
    _ref, plain = both(argv, tmp_path, capsys)
    kept, full = json.loads(got[1]), json.loads(plain[1])

    def findings(doc, kind):
        return [f for r in doc.get("Results") or []
                for f in r.get(kind) or []]

    kinds = ["Vulnerabilities"] + (["Secrets", "Misconfigurations"]
                                   if cmd != "sbom" else [])
    for kind in kinds:
        k, f = findings(kept, kind), findings(full, kind)
        assert 0 < len(k) < len(f), kind


def test_ignore_policy_from_env_and_config_equals_reference(
        corpus, tmp_path, capsys, monkeypatch):
    cfg = tmp_path / "trivy-tpu.yaml"
    cfg.write_text(f"ignore-policy: {corpus['tmp'] / 'ignore.yaml'}\n")
    argv = ["fs", corpus["tree"], "--format", "json", "--quiet",
            "--db-path", corpus["db"], "--config", str(cfg)]
    want, got = both(argv, tmp_path, capsys)
    assert got == want and want[0] == 0
    monkeypatch.setenv("TRIVY_TPU_IGNORE_POLICY",
                       str(corpus["tmp"] / "ignore.rego"))
    want2, got2 = both(argv, tmp_path, capsys)
    assert got2 == want2 and got2 == got


@pytest.mark.parametrize("body,suffix", [
    ("package trivy\nignore { input.x == }\n", ".rego"),
    ("ignore: nope\n", ".yaml"),
    ("raise ImportError('no')\n", ".py"),
    ("x", ".toml"),
])
def test_a_bad_ignore_policy_is_one_error_line(corpus, tmp_path, capsys,
                                               body, suffix):
    pol = tmp_path / f"p{suffix}"
    pol.write_text(body)
    errs = {}
    for P in PKGS:
        assert P.cli.main(["sbom", corpus["sbom"], "--db-path", corpus["db"],
                           "--ignore-policy", str(pol), "--cache-dir",
                           str(tmp_path / P.name)] + P.device) == 1
        captured = capsys.readouterr()
        lines = [ln for ln in captured.err.splitlines() if "ERROR" in ln]
        assert captured.out == "" and len(lines) == 1
        errs[P.name] = lines[0].split("ERROR", 1)[1]
    assert errs["port"] == errs["ref"] and "ignore policy" in errs["port"]


def test_fleet_scan_journals_the_ignore_policy(corpus, tmp_path, capsys):
    """A fleet scan (`--targets`) with `--ignore-policy`: the merged
    report and the journal equal the reference's, and a `--resume` with
    another policy is refused with the reference's message."""
    targets = tmp_path / "targets.txt"
    targets.write_text(f"{corpus['tar']}\n")
    rego = str(corpus["tmp"] / "ignore.rego")
    out = {}
    for P in PKGS:
        P.uuid.reset()
        j = tmp_path / f"j-{P.name}.jsonl"
        argv = ["image", corpus["tar"], "--targets", str(targets),
                "--format", "json", "--db-path", corpus["db"],
                "--cache-dir", str(tmp_path / f"c-{P.name}"), "--quiet",
                "--scanners", "vuln,secret", "--ignore-policy", rego]
        assert P.cli.main(argv + ["--journal", str(j), "--output",
                                  str(tmp_path / f"o-{P.name}.json")]
                          + P.device) == 0
        resume = argv[:-1] + [str(corpus["tmp"] / "ignore.yaml"),
                              "--resume", str(j)]
        resume.remove("--quiet")
        capsys.readouterr()
        assert P.cli.main(resume + P.device) == 1
        err = [ln for ln in capsys.readouterr().err.splitlines()
               if "ERROR" in ln]
        assert len(err) == 1
        out[P.name] = ((tmp_path / f"o-{P.name}.json").read_bytes(),
                       j.read_bytes(),
                       err[0].split("ERROR", 1)[1].replace(str(j), "J"))
    assert out["port"] == out["ref"]


def test_report_is_the_same_under_two_hash_seeds(corpus, tmp_path):
    """`fs --scanners misconfig` with phase 21's checks and bundle: the
    same bytes from two processes with different PYTHONHASHSEED."""
    custom = corpus["custom"]
    outs = []
    for seed in ("1", "4242"):
        cache = str(tmp_path / f"c{seed}")
        chip_smoke.place_bundle(cache)
        env = {**os.environ, "PYTHONHASHSEED": seed,
               "TRIVY_TPU_FAKE_TIME": FAKE_TIME,
               "TRIVY_TPU_DETERMINISTIC_UUID": "1",
               "PYTHONPATH": REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", "")}
        proc = subprocess.run(
            [sys.executable, "-m", "trivy_tpu_torch", "fs", corpus["tree"],
             "--scanners", "misconfig", "--format", "json", "--quiet",
             "--device", "cpu", "--cache-dir", cache,
             *chip_smoke.custom_check_flags(custom)],
            cwd=REPO, env=env, capture_output=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout)
    assert outs[0] == outs[1]
    assert set(chip_smoke.IAC_CUSTOM_IDS) <= failed_ids(outs[0].decode())


# ------------------------------------------------------------ on a card


@pytest.mark.cuda
def test_cuda_custom_checks_equal_device_cpu(corpus, tmp_path, capsys):
    """On a card: phase 21 (a)'s command (custom checks, data, bundle,
    ignore policy) on cuda:0 writes the report of `--device cpu`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    custom = corpus["custom"]
    outs = {}
    for dev in ("cpu", "cuda:0"):
        cache = str(tmp_path / dev)
        chip_smoke.place_bundle(cache)
        PORT.uuid.reset()
        rc = PORT.cli.main(["fs", corpus["tree"], "--format", "json",
                            "--quiet", "--db-path", corpus["db"],
                            "--scanners", "vuln,secret,misconfig",
                            "--cache-dir", cache, "--device", dev,
                            *chip_smoke.custom_check_flags(custom)])
        outs[dev] = (rc, capsys.readouterr().out)
    assert outs["cuda:0"] == outs["cpu"] and outs["cpu"][0] == 0
