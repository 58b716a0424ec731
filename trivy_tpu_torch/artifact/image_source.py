"""Image acquisition backends (reference pkg/fanal/image/image.go:17-58
source chain docker → containerd → podman → remote registry, and
pkg/fanal/image/{daemon,registry,remote}.go).

Every backend yields the same surface as artifact.image.TarImage —
name/config/config_digest/diff_ids()/layer_bytes(i)/close(), plus the
optional streaming layer_stream(i) — so the layer-analysis pipeline is
source-agnostic:

- DaemonImage: docker/podman engine API over a unix socket; the image
  is exported (`GET /images/{ref}/get`, i.e. docker-save) into a spooled
  temp file and re-read as a TarImage.  Mirrors the reference's daemon
  bridge (pkg/fanal/image/daemon/image.go).
- RegistryImage: OCI Distribution HTTP API with Bearer-token and basic
  auth (pkg/fanal/image/registry + go-containerregistry remote):
  manifest (index → platform pick) → config blob → lazy layer blobs.
- resolve_image(): the fallback chain; each failed source's error is
  collected and reported together (image.go:42-58).

Copy of trivy_tpu/artifact/image_source.py.
"""

from __future__ import annotations

import base64
import gzip
import hashlib
import http.client
import json
import os
import re
import socket
import tempfile
import urllib.error
import urllib.parse
import urllib.request

from trivy_tpu_torch.log import logger

_log = logger("image")


class SourceError(Exception):
    pass


# --------------------------------------------------------------- refs


_DEFAULT_REGISTRY = "index.docker.io"
_TAG_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9._-]{0,127}$")


def parse_reference(ref: str) -> tuple[str, str, str, str]:
    """'registry/repo:tag@digest' -> (registry, repository, tag, digest).

    Docker-style shortnames: a first component without '.'/':' is not a
    registry host, and bare official images live under 'library/'."""
    digest = ""
    if "@" in ref:
        ref, digest = ref.split("@", 1)

    registry = _DEFAULT_REGISTRY
    rest = ref
    first, _, remainder = ref.partition("/")
    if remainder and ("." in first or ":" in first or first == "localhost"):
        registry, rest = first, remainder

    tag = ""
    if ":" in rest:
        maybe_repo, maybe_tag = rest.rsplit(":", 1)
        if _TAG_RE.match(maybe_tag) and "/" not in maybe_tag:
            rest, tag = maybe_repo, maybe_tag
    if not tag and not digest:
        tag = "latest"

    if registry == _DEFAULT_REGISTRY and "/" not in rest:
        rest = f"library/{rest}"
    return registry, rest, tag, digest


# ------------------------------------------------------ daemon clients


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 60.0):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


DOCKER_SOCKETS = ("/var/run/docker.sock",)
PODMAN_SOCKETS = (
    "/run/podman/podman.sock",
    os.path.expanduser("~/.local/share/containers/podman/machine/podman.sock"),
)


def _runtime_podman_socket() -> str:
    run_dir = os.environ.get("XDG_RUNTIME_DIR", "")
    return os.path.join(run_dir, "podman", "podman.sock") if run_dir else ""


class DaemonImage:
    """An image exported from a docker/podman-compatible engine socket.

    The export endpoint streams a docker-save archive; it is spooled to
    a temp file and handed to TarImage so layer access is seekable
    (reference daemon/image.go caches the exported tar the same way)."""

    def __init__(self, ref: str, socket_path: str):
        from trivy_tpu_torch.artifact.image import TarImage

        self.socket_path = socket_path
        self._tmp = None
        conn = _UnixHTTPConnection(socket_path)
        try:
            quoted = urllib.parse.quote(ref, safe="")
            # inspect first: cheap 404 for a missing image
            conn.request("GET", f"/images/{quoted}/json",
                         headers={"Host": "docker"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status == 404:
                raise SourceError(f"image {ref!r} not found in daemon")
            if resp.status != 200:
                raise SourceError(
                    f"daemon inspect failed: HTTP {resp.status}")
            self.inspect = json.loads(body)

            conn.request("GET", f"/images/{quoted}/get",
                         headers={"Host": "docker"})
            resp = conn.getresponse()
            if resp.status != 200:
                raise SourceError(f"daemon export failed: HTTP {resp.status}")
            self._tmp = tempfile.NamedTemporaryFile(
                suffix=".tar", prefix="trivy-tpu-daemon-")
            while chunk := resp.read(1 << 20):
                self._tmp.write(chunk)
            self._tmp.flush()
        except (OSError, http.client.HTTPException) as e:
            self.close()
            raise SourceError(f"daemon at {socket_path}: {e}") from e
        except SourceError:
            self.close()
            raise
        finally:
            conn.close()

        self._tar = TarImage(self._tmp.name)
        if ":" in ref or "/" in ref:
            self._tar.name = ref

    @property
    def name(self):
        return self._tar.name

    @property
    def config(self):
        return self._tar.config

    @property
    def config_digest(self):
        return self._tar.config_digest

    def diff_ids(self):
        return self._tar.diff_ids()

    def layer_bytes(self, i: int) -> bytes:
        return self._tar.layer_bytes(i)

    def layer_stream(self, i: int):
        return self._tar.layer_stream(i)

    def close(self):
        if getattr(self, "_tar", None) is not None:
            self._tar.close()
        if self._tmp is not None:
            self._tmp.close()
            self._tmp = None


# ----------------------------------------------------- registry client


_MANIFEST_TYPES = ", ".join([
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.oci.image.index.v1+json",
])
_INDEX_TYPES = (
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json",
)


def _docker_config_auth(registry: str) -> str | None:
    """Authorization header value from ~/.docker/config.json, if any."""
    path = os.path.join(
        os.environ.get("DOCKER_CONFIG",
                       os.path.expanduser("~/.docker")), "config.json")
    try:
        with open(path, "rb") as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        return None
    auths = cfg.get("auths") or {}
    for key in (registry, f"https://{registry}", f"https://{registry}/v1/"):
        entry = auths.get(key)
        if entry and entry.get("auth"):
            return "Basic " + entry["auth"]
    return None


class RegistryClient:
    """Minimal OCI Distribution API client with the anonymous/basic
    Bearer-token dance (reference go-containerregistry transport)."""

    def __init__(self, registry: str, insecure: bool = False,
                 username: str = "", password: str = ""):
        self.registry = registry
        self.scheme = "http" if insecure else "https"
        self._token: str | None = None
        self._basic: str | None = None
        if username or password:
            raw = f"{username}:{password}".encode()
            self._basic = "Basic " + base64.b64encode(raw).decode()
        else:
            self._basic = _docker_config_auth(registry)

    def _request(self, url: str, headers: dict, *,
                 want_bytes: bool = True) -> tuple[bytes, dict]:
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read(), dict(resp.headers)

    def _authed_get(self, path: str, accept: str,
                    repository: str) -> tuple[bytes, dict]:
        url = f"{self.scheme}://{self.registry}{path}"
        headers = {"Accept": accept}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        elif self._basic:
            headers["Authorization"] = self._basic
        try:
            return self._request(url, headers)
        except urllib.error.HTTPError as e:
            if e.code != 401:
                raise SourceError(f"registry GET {path}: HTTP {e.code}")
            challenge = e.headers.get("WWW-Authenticate", "")
            token = self._fetch_token(challenge, repository)
            if not token:
                raise SourceError(f"registry GET {path}: unauthorized")
            self._token = token
            headers["Authorization"] = f"Bearer {token}"
            try:
                return self._request(url, headers)
            except urllib.error.HTTPError as e2:
                raise SourceError(f"registry GET {path}: HTTP {e2.code}")

    def _fetch_token(self, challenge: str, repository: str) -> str | None:
        """Bearer realm="…",service="…" -> GET realm?service&scope."""
        if not challenge.lower().startswith("bearer"):
            return None
        params = dict(re.findall(r'(\w+)="([^"]*)"', challenge))
        realm = params.get("realm")
        if not realm:
            return None
        query = {
            "scope": f"repository:{repository}:pull",
        }
        if params.get("service"):
            query["service"] = params["service"]
        url = realm + "?" + urllib.parse.urlencode(query)
        headers = {}
        if self._basic:
            headers["Authorization"] = self._basic
        try:
            body, _ = self._request(url, headers)
            doc = json.loads(body)
            return doc.get("token") or doc.get("access_token")
        except (urllib.error.URLError, ValueError):
            return None

    def manifest(self, repository: str, reference: str) -> tuple[dict, str]:
        body, headers = self._authed_get(
            f"/v2/{repository}/manifests/{reference}", _MANIFEST_TYPES,
            repository)
        ctype = headers.get("Content-Type", "")
        digest = headers.get("Docker-Content-Digest") or \
            "sha256:" + hashlib.sha256(body).hexdigest()
        doc = json.loads(body)
        if ctype in _INDEX_TYPES or "manifests" in doc:
            child = self._pick_platform(doc.get("manifests") or [])
            if child is None:
                raise SourceError("image index has no usable manifest")
            return self.manifest(repository, child["digest"])
        return doc, digest

    @staticmethod
    def _pick_platform(manifests: list[dict]) -> dict | None:
        best = None
        for m in manifests:
            plat = m.get("platform") or {}
            if plat.get("os") == "linux" and plat.get("architecture") \
                    in ("amd64", "x86_64"):
                return m
            if plat.get("os") == "linux" and best is None:
                best = m
        return best or (manifests[0] if manifests else None)

    def blob(self, repository: str, digest: str) -> bytes:
        body, _ = self._authed_get(
            f"/v2/{repository}/blobs/{digest}",
            "application/octet-stream", repository)
        return body


class RegistryImage:
    """An image pulled blob-by-blob from an OCI registry; layers are
    fetched lazily at analysis time (reference remote.go)."""

    def __init__(self, ref: str, insecure: bool = False,
                 username: str = "", password: str = ""):
        registry, repo, tag, digest = parse_reference(ref)
        self.client = RegistryClient(registry, insecure=insecure,
                                     username=username, password=password)
        self.repository = repo
        self.name = ref
        try:
            self.manifest, self.manifest_digest = self.client.manifest(
                repo, digest or tag)
            cfg_digest = (self.manifest.get("config") or {}).get("digest")
            if not cfg_digest:
                raise SourceError("manifest has no config descriptor")
            cfg_raw = self.client.blob(repo, cfg_digest)
            self.config = json.loads(cfg_raw)
            self.config_digest = cfg_digest
        except urllib.error.URLError as e:
            raise SourceError(f"registry {registry}: {e}") from e
        self._layers = self.manifest.get("layers") or []
        self.repo_digest = f"{registry}/{repo}@{self.manifest_digest}" \
            if registry != _DEFAULT_REGISTRY else \
            f"{repo}@{self.manifest_digest}"

    def diff_ids(self):
        return list((self.config.get("rootfs") or {}).get("diff_ids") or [])

    def layer_bytes(self, i: int) -> bytes:
        desc = self._layers[i]
        data = self.client.blob(self.repository, desc["digest"])
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        return data

    def layer_stream(self, i: int):
        """Registry blob as a stream of its wire bytes; the tar walk's
        stream mode gunzips incrementally, so the decompressed layer
        never fully materializes."""
        import io

        desc = self._layers[i]
        return io.BytesIO(self.client.blob(self.repository, desc["digest"]))

    def close(self):
        pass


# ------------------------------------------------------ fallback chain


def resolve_image(target: str,
                  sources: tuple[str, ...] = ("containerd", "docker", "podman", "remote"),
                  insecure: bool = False,
                  username: str = "", password: str = ""):
    """Try each source in order, collecting errors
    (reference image.go:42-58)."""
    errors: list[str] = []
    for source in sources:
        try:
            if source == "containerd":
                from trivy_tpu_torch.artifact.containerd import (
                    ContainerdImage,
                    containerd_root,
                )

                if not os.path.exists(containerd_root()):
                    raise SourceError("no containerd root found")
                try:
                    return ContainerdImage(target)
                except Exception as e:
                    # ANY containerd failure (permissions, corrupt bolt
                    # pages, bad blobs) must fall through to the next
                    # source, never abort the chain
                    raise SourceError(str(e))
            if source == "docker":
                host = os.environ.get("DOCKER_HOST", "")
                if host.startswith("unix://"):
                    cands: tuple[str, ...] = (host[len("unix://"):],)
                else:
                    cands = DOCKER_SOCKETS
                for sock_path in cands:
                    if os.path.exists(sock_path):
                        return DaemonImage(target, sock_path)
                raise SourceError("no docker socket found")
            if source == "podman":
                cands = tuple(p for p in
                              (_runtime_podman_socket(),) + PODMAN_SOCKETS
                              if p)
                for sock_path in cands:
                    if os.path.exists(sock_path):
                        return DaemonImage(target, sock_path)
                raise SourceError("no podman socket found")
            if source == "remote":
                return RegistryImage(target, insecure=insecure,
                                     username=username, password=password)
            raise SourceError(f"unknown image source {source!r}")
        except SourceError as e:
            errors.append(f"{source}: {e}")
            _log.debug("image source failed", source=source, err=str(e))
    raise SourceError(
        f"unable to resolve image {target!r}: " + "; ".join(errors))
