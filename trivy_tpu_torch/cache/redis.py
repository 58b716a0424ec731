"""Redis cache backend (reference pkg/cache/redis.go): the same
ArtifactCache/LocalArtifactCache surface over a shared Redis, keys
prefixed `fanal::artifact::…` / `fanal::blob::…` exactly like the
reference so caches interoperate across scanners.

No redis client library is baked into this image, so the transport is a
minimal RESP2 implementation over a stdlib socket (optionally wrapped in
TLS with CA/client-cert options, reference redis.go:57-100).  Only the
five commands the cache needs are used: GET/SET/EXISTS/DEL/PING.

Copy of trivy_tpu/cache/redis.py, whole: its keys equal the reference's,
so one redis tier serves both packages.
"""

from __future__ import annotations

import json
import socket
import ssl
import threading

from trivy_tpu_torch.analysis.witness import make_lock
import urllib.parse
from dataclasses import asdict

REDIS_PREFIX = "fanal"


class RedisError(Exception):
    pass


class RespClient:
    """Minimal RESP2 client: one socket, thread-safe command execution."""

    def __init__(self, host: str, port: int, *, username: str = "",
                 password: str = "", db: int = 0, tls: bool = False,
                 ca_cert: str = "", cert: str = "", key: str = "",
                 insecure: bool = False, timeout: float = 10.0):
        sock = socket.create_connection((host, port), timeout=timeout)
        if tls:
            # No --redis-ca means "verify against system roots", never
            # "don't verify"; disabling verification requires an explicit
            # insecure opt-in (reference redis.go errors without CA+cert+key).
            ctx = ssl.create_default_context(cafile=ca_cert or None)
            if insecure:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if cert and key:
                ctx.load_cert_chain(cert, key)
            sock = ctx.wrap_socket(sock, server_hostname=host)
        self._sock = sock
        self._buf = b""
        self._lock = make_lock("cache.redis._lock")
        if password:
            args = ["AUTH", username, password] if username \
                else ["AUTH", password]
            self.execute(*args)
        if db:
            self.execute("SELECT", str(db))
        self.execute("PING")  # validate the connection (and auth) upfront

    # --------------------------------------------------------- protocol

    def _send(self, *args: str | bytes) -> None:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        self._sock.sendall(b"".join(out))

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply()
                                         for _ in range(n)]
        raise RedisError(f"unexpected reply type {line!r}")

    def execute(self, *args):
        with self._lock:
            self._send(*args)
            return self._read_reply()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def parse_redis_url(url: str) -> dict:
    """redis://[user:pass@]host:port[/db]"""
    u = urllib.parse.urlparse(url)
    if u.scheme not in ("redis", "rediss"):
        raise RedisError(f"unsupported redis URL scheme {u.scheme!r}")
    db = 0
    if u.path and u.path.strip("/"):
        try:
            db = int(u.path.strip("/"))
        except ValueError:
            raise RedisError(f"invalid redis db in URL: {u.path!r}")
    return {
        "host": u.hostname or "localhost",
        "port": u.port or 6379,
        "username": u.username or "",
        "password": u.password or "",
        "db": db,
        "tls": u.scheme == "rediss",
    }


class RedisCache:
    """ArtifactCache + LocalArtifactCache over Redis
    (reference pkg/cache/redis.go:102-210)."""

    def __init__(self, backend: str, *, ca_cert: str = "", cert: str = "",
                 key: str = "", tls: bool = False, ttl: int = 0,
                 insecure: bool = False, client: RespClient | None = None):
        if client is not None:
            self._client = client
        else:
            opts = parse_redis_url(backend)
            opts["tls"] = opts["tls"] or tls
            self._client = RespClient(
                opts["host"], opts["port"], username=opts["username"],
                password=opts["password"], db=opts["db"], tls=opts["tls"],
                ca_cert=ca_cert, cert=cert, key=key, insecure=insecure)
        self.ttl = ttl

    @staticmethod
    def _artifact_key(artifact_id: str) -> str:
        return f"{REDIS_PREFIX}::artifact::{artifact_id}"

    @staticmethod
    def _blob_key(blob_id: str) -> str:
        return f"{REDIS_PREFIX}::blob::{blob_id}"

    def _set(self, key: str, doc: dict) -> None:
        args = ["SET", key, json.dumps(doc, default=str)]
        if self.ttl:
            args += ["EX", str(self.ttl)]
        self._client.execute(*args)

    def _get(self, key: str) -> dict:
        raw = self._client.execute("GET", key)
        if raw is None:
            return {}
        return json.loads(raw)

    # ---------------------------------------------------- ArtifactCache

    def put_artifact(self, artifact_id: str, info) -> None:
        doc = info if isinstance(info, dict) else asdict(info)
        self._set(self._artifact_key(artifact_id), doc)

    def put_blob(self, blob_id: str, blob) -> None:
        doc = blob if isinstance(blob, dict) else asdict(blob)
        self._set(self._blob_key(blob_id), doc)

    def missing_blobs(self, artifact_id: str,
                      blob_ids: list[str]) -> tuple[bool, list[str]]:
        missing = [
            bid for bid in blob_ids
            if not self._client.execute("EXISTS", self._blob_key(bid))
        ]
        missing_artifact = not self._client.execute(
            "EXISTS", self._artifact_key(artifact_id))
        return missing_artifact, missing

    def delete_blobs(self, blob_ids: list[str]) -> None:
        if blob_ids:
            self._client.execute(
                "DEL", *[self._blob_key(b) for b in blob_ids])

    # ----------------------------------------------- LocalArtifactCache

    def get_artifact(self, artifact_id: str) -> dict:
        return self._get(self._artifact_key(artifact_id))

    def get_blob(self, blob_id: str) -> dict:
        return self._get(self._blob_key(blob_id))

    def clear(self) -> None:
        # delete only our keys, not the whole redis (redis.go:194-210)
        cursor = "0"
        while True:
            reply = self._client.execute(
                "SCAN", cursor, "MATCH", f"{REDIS_PREFIX}::*", "COUNT", "100")
            cursor = reply[0].decode() if isinstance(reply[0], bytes) \
                else str(reply[0])
            keys = reply[1] or []
            if keys:
                self._client.execute("DEL", *keys)
            if cursor == "0":
                break

    def close(self) -> None:
        self._client.close()
