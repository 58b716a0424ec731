"""Port parity, the `repository` / `repo` scan path: trivy_tpu_torch's
`RepoArtifact` (git checkout rules) and CLI (`--device cpu`, so the
match kernel's and the secret screens' plain versions answer, or
`--no-tpu`) against the JAX package's on the same repositories: a local
directory as it stands, and a local directory or a file:// URL at a
branch, a tag or a commit. The shapes of tests/test_fanal.py
TestRepoCheckout run on the port's artifact. Plus the repository
gating (no OS analyzers: a `repo` scan's results are an `fs` scan's
less the OS-packages result), the user's checkout left as it was, temp
clones removed, and the options `repo` refuses.

Blob ids of a repository scan come from a uuid, as a filesystem
scan's: both packages run under TRIVY_TPU_DETERMINISTIC_UUID=1 with
their counters reset before each scan. Reports are compared as bytes.
"""

import glob
import json
import os
import re
import subprocess
import sys
import tempfile

import pytest
import test_fanal
import torch
from test_torch_fanal import seeded_db, seeded_tree

from trivy_tpu.cli import main as jax_main
from trivy_tpu.cli import run as jax_run
from trivy_tpu.fanal import analyzer as jax_analyzer
from trivy_tpu.utils import uuid as jax_uuid
from trivy_tpu_torch.artifact import local_fs
from trivy_tpu_torch.artifact.repo import RepoArtifact
from trivy_tpu_torch.cache.cache import MemoryCache
from trivy_tpu_torch.cli import config, run
from trivy_tpu_torch.cli.main import build_parser, main
from trivy_tpu_torch.fanal import analyzer as port_analyzer
from trivy_tpu_torch.fanal.analyzers import secret_analyzer
from trivy_tpu_torch.secret import scanner as sc
from trivy_tpu_torch.utils import uuid as port_uuid

FAKE_TIME = "2024-01-01T00:00:00+00:00"
GIT_ENV = {"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
           "GIT_AUTHOR_DATE": FAKE_TIME, "GIT_COMMITTER_DATE": FAKE_TIME,
           "GIT_CONFIG_NOSYSTEM": "1", "GIT_CONFIG_GLOBAL": os.devnull}


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
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("TRIVY_TPU_FAKE_TIME", FAKE_TIME)
    monkeypatch.setenv("TRIVY_TPU_DETERMINISTIC_UUID", "1")
    monkeypatch.setattr(secret_analyzer, "USE_DEVICE", "hybrid")
    monkeypatch.setattr(secret_analyzer, "DEVICE", torch.device("cpu"))
    monkeypatch.setattr(sc, "_CACHE_DIR_OVERRIDE", None)
    # clones go to a temp dir of this test's own, counted afterwards
    (tmp_path / "tmp").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr(tempfile, "tempdir", None)
    # a CLI scan leaves its --secret-config path on the process-wide
    # secret analyzer: start each test with none in both packages
    for registry in (jax_analyzer._POST_ANALYZERS,
                     port_analyzer._POST_ANALYZERS):
        for a in registry:
            if a.type == "secret":
                a.configure(None)
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()
    yield
    run._ENGINE_CACHE.clear()
    jax_run._ENGINE_CACHE.clear()


def git(repo, *args) -> str:
    return subprocess.run(["git", "-C", str(repo), *args], check=True,
                          capture_output=True, text=True,
                          env={**os.environ, **GIT_ENV}).stdout.strip()


def clones(tmp_path) -> list:
    return glob.glob(str(tmp_path / "tmp" / "trivy-tpu-repo-*"))


def checkout_state(repo) -> tuple:
    files = {}
    for d, dirs, names in os.walk(repo):
        dirs[:] = [x for x in dirs if x != ".git"]
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, repo)] = f.read()
    return (git(repo, "rev-parse", "HEAD"), git(repo, "status",
                                                "--porcelain"), files)


@pytest.fixture(scope="module")
def seeded_repo(tmp_path_factory):
    """The seeded scan tree as a git repository: commit 1 (tagged v1)
    the tree; commit 2 on main a newer pip requirement and a new
    secret; branch `release` from v1 with an npm lockfile change. The
    checkout is left on main. Plus the seeded DB, saved."""
    tmp = tmp_path_factory.mktemp("repo")
    repo = tmp / "src"
    seeded_tree(repo)
    subprocess.run(["git", "init", "-q", "-b", "main", str(repo)],
                   check=True, capture_output=True,
                   env={**os.environ, **GIT_ENV})
    git(repo, "add", "-A")
    git(repo, "commit", "-qm", "v1")
    git(repo, "tag", "v1")
    first = git(repo, "rev-parse", "HEAD")
    (repo / "app" / "requirements-prod.txt").write_text("requests==2.20.0\n")
    (repo / "src" / "new.py").write_text(
        'KEY = "AKIA' + "B" * 16 + '"\n')
    git(repo, "add", "-A")
    git(repo, "commit", "-qm", "main")
    git(repo, "checkout", "-q", "-b", "release", "v1")
    (repo / "app" / "yarn.lock").write_text("")
    git(repo, "add", "-A")
    git(repo, "commit", "-qm", "release")
    git(repo, "checkout", "-q", "main")
    seeded_db().save(str(tmp / "db"))
    return {"repo": str(repo), "first": first, "db": str(tmp / "db")}


# ----------------------- tests/test_fanal.py TestRepoCheckout, port


def blob_packages(art, ref) -> list:
    blob = art.cache.get_blob(ref.blob_ids[0])
    return [p for a in blob["applications"] for p in a["packages"]]


class TestRepoCheckout:
    def test_clone_tag(self, tmp_path):
        repo = test_fanal.TestRepoCheckout._mk_repo(None, tmp_path)
        art = RepoArtifact(f"file://{repo}", MemoryCache(), tag="v1.0")
        ref = art.inspect()
        assert blob_packages(art, ref)[0]["version"] == "1.0"
        art.clean(ref)
        assert art._tmp is None

    def test_local_dir_with_revision_does_not_mutate(self, tmp_path):
        """A local directory at a revision is cloned to a temp dir, never
        checked out in place."""
        repo = test_fanal.TestRepoCheckout._mk_repo(None, tmp_path)
        before = checkout_state(repo)
        art = RepoArtifact(str(repo), MemoryCache(), tag="v1.0")
        ref = art.inspect()
        assert blob_packages(art, ref)[0]["version"] == "1.0"
        assert checkout_state(repo) == before
        art.clean(ref)

    def test_branch_tag_conflict(self):
        art = RepoArtifact("https://x/r.git", MemoryCache(),
                           branch="main", tag="v1")
        with pytest.raises(RuntimeError, match="mutually exclusive"):
            art.inspect()

    def test_dash_ref_rejected(self):
        art = RepoArtifact("https://x/r.git", MemoryCache(), commit="-f")
        with pytest.raises(RuntimeError, match="invalid git ref"):
            art.inspect()

    def test_failed_clone_cleans_tmp(self, tmp_path):
        art = RepoArtifact(f"file://{tmp_path}/nope.git", MemoryCache(),
                           branch="missing")
        with pytest.raises(RuntimeError):
            art.inspect()
        assert not clones(tmp_path)


def test_failed_walk_cleans_tmp(tmp_path, monkeypatch):
    """A walk that fails after the clone removes the clone too (no
    reference comes back, so no clean() would follow)."""
    repo = test_fanal.TestRepoCheckout._mk_repo(None, tmp_path)

    def boom(self):
        assert clones(tmp_path)  # the walk runs inside the clone
        raise OSError("disk gone")

    monkeypatch.setattr(local_fs.FSArtifact, "inspect", boom)
    art = RepoArtifact(str(repo), MemoryCache(), commit="v1.0")
    with pytest.raises(OSError, match="disk gone"):
        art.inspect()
    assert not clones(tmp_path) and art._tmp is None


def test_clone_flags(tmp_path, monkeypatch):
    """The clone rules: --local for a local directory, --depth 1 for a
    URL unless a commit is asked for, --branch for a branch or a tag,
    and the commit checked out in the clone."""
    calls = []
    monkeypatch.setattr(RepoArtifact, "_git",
                        staticmethod(lambda cmd: calls.append(cmd)))
    for target, kw in (("https://x/r.git", {"tag": "v1"}),
                       ("https://x/r.git", {"commit": "abc"}),
                       (str(tmp_path), {"branch": "dev"})):
        art = RepoArtifact(target, MemoryCache(), **kw)
        art._checkout()
        art._drop_clone()
    assert [c[:5] for c in calls] == [
        ["git", "clone", "--depth", "1", "--branch"],
        ["git", "clone", "--", "https://x/r.git", calls[1][4]],
        ["git", "-C", calls[1][4], "checkout", "abc"],
        ["git", "clone", "--local", "--branch", "dev"]]


# --------------------------------------------------------- the CLI


def scan(entry, argv, capsys, uuid_mod) -> tuple[int, str]:
    uuid_mod.reset()
    rc = entry(argv)
    return rc, capsys.readouterr().out


def both(argv, tmp_path, capsys, device=("--device", "cpu")) -> tuple:
    want = scan(jax_main.main, argv + ["--cache-dir", str(tmp_path / "j")],
                capsys, jax_uuid)
    got = scan(main, argv + [*device, "--cache-dir", str(tmp_path / "p")],
               capsys, port_uuid)
    return want, got


REVISIONS = {"local": ("local", ()), "local_tag": ("local", ("--tag", "v1")),
             "url_branch": ("url", ("--branch", "release")),
             "url_tag": ("url", ("--tag", "v1")),
             "url_commit": ("url", ("--commit", None))}


def revision_argv(seeded_repo, rev: str) -> list:
    where, flags = REVISIONS[rev]
    target = seeded_repo["repo"] if where == "local" else \
        f"file://{seeded_repo['repo']}"
    flags = [seeded_repo["first"] if f is None else f for f in flags]
    return [target, *flags]


@pytest.mark.parametrize("no_tpu", [False, True], ids=["device", "no-tpu"])
@pytest.mark.parametrize("rev", list(REVISIONS))
@pytest.mark.parametrize("cmd", ["repository", "repo"])
def test_port_cli_equals_jax_cli(seeded_repo, tmp_path, capsys, cmd, rev,
                                 no_tpu):
    before = checkout_state(seeded_repo["repo"])
    argv = [cmd, *revision_argv(seeded_repo, rev), "--format", "json",
            "--db-path", seeded_repo["db"], "--quiet", "--list-all-pkgs"]
    if no_tpu:
        argv.append("--no-tpu")
    want, got = both(argv, tmp_path, capsys)
    assert got == want
    assert want[0] == 0
    doc = json.loads(got[1])
    assert doc["ArtifactType"] == "repository"
    assert doc["ArtifactName"] == argv[1]
    classes = {r["Class"] for r in doc["Results"]}
    assert classes == {"lang-pkgs", "secret"}  # no OS result
    targets = {r["Target"] for r in doc["Results"]}
    # main's commit 2 added src/new.py; v1 and release lack it
    assert ("src/new.py" in targets) is (rev == "local")
    assert checkout_state(seeded_repo["repo"]) == before
    assert not clones(tmp_path)


def test_tag_and_commit_give_equal_reports(seeded_repo, tmp_path, capsys):
    outs = set()
    for rev in ("url_tag", "url_commit"):
        argv = ["repo", *revision_argv(seeded_repo, rev), "--format",
                "json", "--db-path", seeded_repo["db"], "--quiet"]
        rc, out = scan(main, argv + ["--device", "cpu", "--cache-dir",
                                     str(tmp_path / "c")], capsys,
                       port_uuid)
        assert rc == 0
        doc = json.loads(out)
        outs.add(json.dumps(doc["Results"]))
    assert len(outs) == 1


@pytest.mark.parametrize("entry,uuid_mod", [(jax_main.main, jax_uuid),
                                            (main, port_uuid)],
                         ids=["reference", "port"])
def test_repo_results_are_fs_results_less_os(seeded_repo, tmp_path, capsys,
                                             entry, uuid_mod):
    """The repository gating turns the OS analyzers off: on the same
    directory, `repo`'s results are `fs`'s without the OS-packages
    result, in the reference and in the port (chip_smoke.py phase 11
    (a) checks the same on the card)."""
    results = {}
    for cmd in ("fs", "repo"):
        argv = [cmd, seeded_repo["repo"], "--format", "json", "--db-path",
                seeded_repo["db"], "--quiet", "--cache-dir",
                str(tmp_path / "c")]
        if entry is main:
            argv += ["--device", "cpu"]
        rc, out = scan(entry, argv, capsys, uuid_mod)
        assert rc == 0
        results[cmd] = json.loads(out)["Results"]
    less_os = [r for r in results["fs"] if r["Class"] != "os-pkgs"]
    assert len(less_os) == len(results["fs"]) - 1
    assert results["repo"] == less_os


def error_lines(err: str) -> list:
    """The message of each ERROR log line (no timestamp; the temp
    clone's random name made `trivy-tpu-repo-*`)."""
    return [re.sub(r"trivy-tpu-repo-\w+", "trivy-tpu-repo-*",
                   ln.split("\t", 2)[2])
            for ln in err.splitlines() if "\tERROR\t" in ln]


@pytest.mark.parametrize("flags,message", [
    (("--branch", "main", "--tag", "v1"), "mutually exclusive"),
    (("--commit=-f",), "invalid git ref"),
    (("--branch", "missing"), "git failed (git clone --local)"),
], ids=["branch-and-tag", "dash-ref", "missing-branch"])
def test_repo_errors_equal_reference(seeded_repo, tmp_path, capsys, flags,
                                     message):
    argv = ["repo", seeded_repo["repo"], *flags, "--format", "json",
            "--no-tpu"]
    got = [main(argv + ["--cache-dir", str(tmp_path / "p")])]
    got.append(error_lines(capsys.readouterr().err))
    want = [jax_main.main(argv + ["--cache-dir", str(tmp_path / "j")])]
    want.append(error_lines(capsys.readouterr().err))
    assert got == want
    assert got[0] == 1 and len(got[1]) == 1 and message in got[1][0]
    assert not clones(tmp_path)


def test_revision_flags_only_on_repository_parsers():
    parser = build_parser()
    for cmd in ("repository", "repo"):
        args = parser.parse_args([cmd, "x", "--branch", "b", "--tag", "t",
                                  "--commit", "c"])
        assert (args.branch, args.tag, args.commit) == ("b", "t", "c")
    for cmd in ("fs", "vm"):
        with pytest.raises(SystemExit):
            parser.parse_args([cmd, "x", "--branch", "b"])


@pytest.mark.parametrize("cmd", ["repository", "repo"])
@pytest.mark.parametrize("dest,value", [("config_check", "checks/"),
                                        ("license_full", "true"),
                                        ("report", "all")])
def test_unported_option_from_env_is_refused(seeded_repo, tmp_path, capsys,
                                             monkeypatch, cmd, dest, value):
    """An unported option from the environment is refused with one line;
    `config_check`, `license_full` and `report` are ported, and give the
    reference's report (`checks/` chip_smoke.py phase 21's checks; a
    license scan for `license_full`)."""
    monkeypatch.setenv("TRIVY_TPU_" + dest.upper(), value)
    if dest != "config_check" and dest not in config.UNPORTED:
        want, got = both([cmd, seeded_repo["repo"], "--db-path",
                          seeded_repo["db"], "--format", "json", "--quiet",
                          "--scanners", "vuln,license"], tmp_path, capsys)
        assert got == want and want[0] == 0
        return
    if dest == "config_check":
        import chip_smoke

        monkeypatch.chdir(tmp_path)
        chip_smoke.write_custom_checks(str(tmp_path))
        want, got = both([cmd, seeded_repo["repo"], "--db-path",
                          seeded_repo["db"], "--format", "json", "--quiet",
                          "--scanners", "vuln,secret,misconfig",
                          "--check-namespaces", "user"], tmp_path, capsys)
        assert got == want and want[0] == 0
        return
    rc = main([cmd, seeded_repo["repo"], "--db-path", seeded_repo["db"],
               "--device", "cpu", "--cache-dir", str(tmp_path / "c")])
    captured = capsys.readouterr()
    lines = captured.err.strip().splitlines()
    assert rc == 1 and captured.out == "" and len(lines) == 1
    assert "not ported yet" in lines[0]
    assert dest.replace("_", "-") in lines[0]


def test_unported_option_from_config_file_is_refused(seeded_repo, tmp_path,
                                                     capsys):
    """`compliance` from a config file (ported; once refused): the
    reference's compliance report."""
    cfg = tmp_path / "trivy-tpu.yaml"
    cfg.write_text("compliance: docker-cis-1.6.0\n")
    want, got = both(["repo", seeded_repo["repo"], "--config", str(cfg),
                      "--db-path", seeded_repo["db"], "--format", "json",
                      "--quiet"], tmp_path, capsys)
    assert got == want and want[0] == 0
    assert json.loads(got[1])["ID"] == "docker-cis-1.6.0"


def test_repo_scan_imports_no_jax_in_a_fresh_process(seeded_repo,
                                                     tmp_path):
    """A CPU repository scan at a tag, through the port's CLI, loads no
    jax module and nothing of the JAX package."""
    code = f"""
import sys
before = set(sys.modules)
from trivy_tpu_torch.cli.main import main
assert main(["repo", {'file://' + seeded_repo['repo']!r}, "--tag", "v1",
             "--db-path", {seeded_repo['db']!r},
             "--cache-dir", {str(tmp_path / 'c')!r}, "--device", "cpu",
             "--quiet", "--format", "json",
             "--output", {str(tmp_path / 'r.json')!r}]) == 0
print("\\n".join(sorted(set(sys.modules) - before)))
"""
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(os.path.dirname(__file__)),
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "trivy_tpu_torch.artifact.repo" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")
                or m == "trivy_tpu" or m.startswith("trivy_tpu.")]
