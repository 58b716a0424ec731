"""Cross-host sharded serving: the distributed MeshDB.

Port of trivy_tpu/ops/dcn.py. The match kernel is a pure map, so each
host answers "which of my rows hit" for the whole query batch against
ONLY its advisory row slice on its own (data x db) grid of devices, and
the coordinator merges the per-host shard bitmaps through the engine's
shard decoder (detector/engine.py `_crunch`'s sharded branch). Nothing
but the encoded query columns and packed hit words crosses the wire;
the hosts run no collective.

Topology (`--mesh HOSTSxDPxDB` / `TRIVY_TPU_MESH`; "auto" sizes the db
axis against `TRIVY_TPU_MESH_HBM_GB` per device per host):

  HOSTS    processes (host 0 = the coordinator, the process serving
           scans); the main tier's rows split into HOSTS * DB global
           shards, host h owning the contiguous run [h*DB, (h+1)*DB).
           This is the axis for advisory sets larger than one host's
           device memory.
  DP x DB  each host's own grid over its devices: ops/mesh.py, per host.

Workers come from ``TRIVY_TPU_DCN``:

  "spawn" / "spawn:N"   the coordinator starts local worker processes
                        (``--device`` the coordinator's placement: the
                        CPU, every cell on one named card, or the first
                        DP*DB cards),
  "host:port,..."       workers started beforehand
                        (``python -m trivy_tpu_torch.ops.dcn --worker
                        [--device D]``) on peer hosts.

Each worker holds ONLY its slice: a warm start loads the host-slice
entry of the compiled-DB cache (tensorize/cache.py `load_host_slice`);
a cold worker asks the coordinator to push the slice over the wire (and
saves it for its next start). The slices are ops/match.py `host_shards`
over the GLOBAL shard count, so the coordinator's decoder reads the
(shard_base, shard_len) layout of the single-host mesh. A worker's
cells are `shard_device_db`s launching the match kernel through
`match_dispatch`; the worker loads the kernel when it builds its grid,
so its cost lands in the hello or load, not in the first match.

The wire is the reference's byte for byte: a ``TDCN1\\n`` magic, a
little-endian u32 header length, a JSON header (``_body``: the npz
length; ``rid``: the request id the worker echoes), and an npz body
read with ``allow_pickle=False``. Only numpy arrays go on it. So a port
coordinator drives a reference worker and the other way round.

Fault site ``engine.host`` (per host, at collect time): ``drop``
re-sends the request, ``delay`` stalls, ``error`` retries up to
`TRIVY_TPU_MESH_SHARD_RETRIES` then degrades, ``device-lost`` degrades
at once. A degraded HOST's slice is recomputed on the coordinator by
the match kernel's plain version over each of the host's global row
ranges (ops/mesh.py `MeshDB._host_mask`), while the other hosts keep
serving on their devices: a degradation changes latency, never bits.
Transport loss (a worker's death or EOF, a socket or reply timeout
after ``TRIVY_TPU_DCN_TIMEOUT_S``, a ``rid`` mismatch, a closed
connection) and protocol states (``stale-slice``, a mask of the wrong
shape) ride the same ladder. A worker's device error (a kernel that
cannot build or launch, a CUDA error, a slice upload that fails) is not
a transport loss: the
worker's reply marks it (``device_error``, a header key a reference
coordinator ignores) and it raises on the coordinator, as a mesh cell's
does.

The reference's DCN metrics (`trivy_tpu_dcn_*`, the mesh shape and
re-resolves) are fed, and the HostMeshDB keeps plain counters beside
them: `degradations` and `host_retry_count` per host,
`dispatches` / `dispatch_s` per host, `merges` / `merge_s`,
`reresolves`, and `build_stats` (where the build's time went).

trivy_tpu/ops/multihost.py has no port file: its one live function,
`crawl_mesh`, is what device.py `build_mesh` does.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.device import DeviceError
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.resilience import faults

_log = logger("dcn")

ENV_DCN = "TRIVY_TPU_DCN"
ENV_TIMEOUT = "TRIVY_TPU_DCN_TIMEOUT_S"

DEFAULT_TIMEOUT_S = 60.0

_MAGIC = b"TDCN1\n"
READY_LINE = "DCN_WORKER_READY port="


class HostFault(faults.FaultError):
    """A remote host's dispatch failed (injected ``engine.host`` error,
    a protocol state): retried, then the host's whole slice degrades."""


class HostLost(HostFault):
    """A remote host is gone (injected ``engine.host`` device-lost):
    its slice degrades without a retry."""


class WorkerDeviceError(DeviceError):
    """A worker's device failed its match or its slice's upload (a
    kernel that cannot build or launch, a CUDA error): raised to the
    caller, never degraded."""


# ------------------------------------------------------------- spec helpers


def configured_workers() -> list[str] | int | str | None:
    """Parse TRIVY_TPU_DCN: None (off), "spawn" (start as many local
    workers as the mesh spec needs), an int (spawn exactly N), or an
    endpoint list. Raises ValueError on a malformed value so a typo
    fails at engine construction, not mid-crawl."""
    raw = os.environ.get(ENV_DCN, "").strip()
    if not raw or raw in ("0", "off"):
        return None
    if raw == "spawn":
        return "spawn"
    if raw.startswith("spawn:"):
        try:
            n = int(raw[6:])
        except ValueError:
            raise ValueError(f"bad {ENV_DCN} spawn count {raw!r}")
        if n < 1:
            raise ValueError(f"{ENV_DCN} spawn count must be >= 1")
        return n
    eps = [e.strip() for e in raw.split(",") if e.strip()]
    for e in eps:
        if ":" not in e:
            raise ValueError(
                f"bad {ENV_DCN} endpoint {e!r}: want host:port")
    return eps


def dcn_timeout_s() -> float:
    raw = os.environ.get(ENV_TIMEOUT, "")
    if raw:
        try:
            return max(float(raw), 0.1)
        except ValueError:
            _log.warn("bad TRIVY_TPU_DCN_TIMEOUT_S; using default",
                      value=raw)
    return DEFAULT_TIMEOUT_S


def choose_host_topology(n_hosts: int, n_local: int,
                         n_rows: int) -> tuple[int, int]:
    """(dp, db_local) for `n_hosts` processes of `n_local` devices each:
    the per-host db axis is the smallest divisor of the local device
    count whose GLOBAL per-shard slice (rows split HOSTS*DB ways) fits
    the per-device memory budget; every other local device goes to
    data."""
    from trivy_tpu_torch.ops.match import TABLE_LANES
    from trivy_tpu_torch.ops.mesh import _hbm_budget_bytes

    n_local = max(int(n_local), 1)
    n_hosts = max(int(n_hosts), 1)
    row_bytes = 4 * (1 + TABLE_LANES)
    budget = _hbm_budget_bytes()
    db_local = n_local
    for cand in range(1, n_local + 1):
        if n_local % cand:
            continue
        per_shard = -(-max(n_rows, 1) // (n_hosts * cand))
        if per_shard * row_bytes <= budget:
            db_local = cand
            break
    return n_local // db_local, db_local


def plan_from_spec(spec: str, n_rows: int, device=None):
    """-> (n_hosts, dp, db_local) when `spec` spans hosts, else None
    (the single-host ops/mesh.py path). A HOSTSxDPxDB spec with hosts
    >= 2 needs TRIVY_TPU_DCN workers; "auto" goes cross-host exactly
    when TRIVY_TPU_DCN is set, sizing each host's grid over the devices
    of `device`'s type (the CUDA cards by default, one for the CPU)."""
    from trivy_tpu_torch.ops import mesh as mesh_ops

    parsed = mesh_ops.parse_spec(spec)
    if parsed is None:
        return None
    workers = configured_workers()
    if parsed == "auto":
        if workers is None:
            return None
        if isinstance(workers, list):
            n_hosts = len(workers) + 1
        elif workers == "spawn":
            n_hosts = 2  # bare "spawn" with auto: one worker
        else:
            n_hosts = workers + 1
        n_local = mesh_ops.local_device_count(
            torch.device("cuda" if device is None else device))
        dp, db_local = choose_host_topology(n_hosts, n_local, n_rows)
        return n_hosts, dp, db_local
    if len(parsed) == 2:
        return None
    n_hosts, dp, db_local = parsed
    if workers is None:
        raise ValueError(
            f"mesh spec {spec!r} spans {n_hosts} hosts but {ENV_DCN} "
            "is unset: point it at worker endpoints (host:port,...) "
            "or 'spawn' to launch local workers")
    if isinstance(workers, list) and len(workers) != n_hosts - 1:
        raise ValueError(
            f"mesh spec {spec!r} needs {n_hosts - 1} workers but "
            f"{ENV_DCN} lists {len(workers)}")
    if isinstance(workers, int) and workers != n_hosts - 1:
        # an explicit spawn COUNT must agree with the explicit spec: a
        # fleet other than the one the operator sized fails at startup
        raise ValueError(
            f"mesh spec {spec!r} needs {n_hosts - 1} spawned workers "
            f"but {ENV_DCN} says spawn:{workers}")
    return n_hosts, dp, db_local


def grid_devices(dp: int, db_local: int, device, side: str,
                 devices=None) -> list[list[torch.device]]:
    """[dp][db_local] devices of one host's grid. `devices` (dp*db_local
    of them, row-major by data group) places the cells as given. Else a
    CUDA `device` without an index takes the first dp*db_local cards
    (raising when there are fewer), and one with an index, or the CPU,
    holds every cell: several cells share a card only when it is named."""
    from trivy_tpu_torch.device import build_mesh

    n = dp * db_local
    if devices is None:
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and device.index is None:
            n_local = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if n > n_local:
                raise ValueError(
                    f"{side} needs {n} local devices, has {n_local}")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [device] * n
    return build_mesh(dp, db_local, devices=devices).devices


# ---------------------------------------------------------------- wire form


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("DCN peer closed the connection")
        buf += chunk
    return bytes(buf)


def _send_msg(sock: socket.socket, header: dict,
              arrays: dict | None = None) -> None:
    payload = b""
    if arrays:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
    h = dict(header)
    h["_body"] = len(payload)
    hb = json.dumps(h).encode()
    sock.sendall(_MAGIC + struct.pack("<I", len(hb)) + hb + payload)


def _recv_msg(sock: socket.socket) -> tuple[dict, dict]:
    magic = _recv_exact(sock, len(_MAGIC))
    if magic != _MAGIC:
        raise ConnectionError(f"bad DCN frame magic {magic!r}")
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, hlen))
    body = _recv_exact(sock, int(header.get("_body", 0)))
    arrays = {}
    if body:
        z = np.load(io.BytesIO(body), allow_pickle=False)
        arrays = {k: z[k] for k in z.files}
    return header, arrays


# ------------------------------------------------------------- remote hosts


class _RemoteHost:
    """One worker connection: a single I/O thread drains a request queue
    (send and receive are strictly request-response per connection), so
    dispatches to different hosts, and the local grid's kernels, overlap
    while each host computes."""

    def __init__(self, idx: int, endpoint: str | None = None,
                 proc=None, sock: socket.socket | None = None):
        import queue

        self.idx = idx
        self.endpoint = endpoint
        self.proc = proc  # spawn mode: the worker process
        self._sock = sock
        self._q: "queue.Queue" = queue.Queue()
        self.info: dict = {}
        self._closed = False
        # request/response correlation: every frame carries a rid the
        # worker echoes; owned by the I/O thread (the socket's one user)
        self._rid = 0
        # the I/O pump emits no spans: the engine.host span and its
        # parentage live on the collecting scan thread
        # lint: allow[tracing-capture] io pump emits no spans; parentage lives on the collecting scan thread
        self._thread = threading.Thread(
            target=self._run, name=f"ttpu-dcn-io-{idx}", daemon=True)
        self._thread.start()

    def request(self, header: dict, arrays: dict | None = None) -> Future:
        fut: Future = Future()
        if self._closed or self._sock is None:
            # fail fast instead of parking the caller for the whole
            # timeout behind a shutdown no thread will drain
            fut.set_exception(
                ConnectionError("DCN worker connection closed"))
            return fut
        self._q.put((header, arrays, fut))
        return fut

    def _mark_broken(self) -> None:
        """A send or receive failed: the stream may hold a partial frame
        or an abandoned request's late reply, so the connection is never
        trusted again. It closes, and every later request fails fast
        (the collectors' engine.host ladder degrades the host). The
        connection is the correlation unit: one failure ends it."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _exchange(self, header: dict, arrays) -> tuple[dict, dict]:
        self._rid += 1
        _send_msg(self._sock, dict(header, rid=self._rid), arrays)
        reply, rarrays = _recv_msg(self._sock)
        if reply.get("rid") != self._rid:
            # a reply for a request this loop never paired (a desynced
            # stream): never trust this connection again
            raise ConnectionError(
                f"worker {self.idx} reply correlation mismatch "
                f"(got rid={reply.get('rid')}, want {self._rid})")
        if not reply.get("ok"):
            what = reply.get("error", "unknown")
            if reply.get("device_error"):
                raise WorkerDeviceError(
                    f"worker {self.idx} device error: {what}")
            raise HostFault(f"worker {self.idx} error: {what}")
        return reply, rarrays

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                # fail whatever was enqueued behind the shutdown (a
                # dispatch racing close()) so its collector degrades now
                while True:
                    try:
                        late = self._q.get_nowait()
                    except Exception:
                        return
                    if late is not None and late[2] is not None:
                        late[2].set_exception(ConnectionError(
                            "DCN worker connection closed"))
            header, arrays, fut = item
            try:
                if self._sock is None:
                    raise ConnectionError("DCN worker connection closed")
                if fut is None:  # fire-and-forget (the shutdown frame)
                    self._rid += 1
                    _send_msg(self._sock, dict(header, rid=self._rid),
                              arrays)
                    continue
                fut.set_result(self._exchange(header, arrays))
            except WorkerDeviceError as exc:
                # a well-formed reply: the stream is in step, and the
                # error raises to the caller, not into the host ladder
                fut.set_exception(exc)
            except Exception as exc:  # every failure reaches the collector
                if not isinstance(exc, (HostFault, OSError)):
                    # an unreadable frame (bad JSON, a bad npz) is a
                    # transport loss like a closed socket
                    exc = ConnectionError(
                        f"worker {self.idx} sent an unreadable frame: "
                        f"{exc!r}")
                self._mark_broken()
                if fut is not None:
                    try:
                        fut.set_exception(exc)
                    except Exception:
                        pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # only workers WE spawned die with us; an endpoint worker
        # outlives its coordinators (it may serve the hot-swap
        # successor next). The shutdown frame rides the request queue
        # so it cannot interleave with an in-flight request's bytes
        if self._sock is not None and self.proc is not None:
            self._q.put(({"op": "shutdown"}, None, None))
        self._q.put(None)
        self._thread.join(timeout=5)
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if self.proc is not None:
            try:
                self.proc.terminate()
                self.proc.wait(timeout=5)
            except Exception:
                try:
                    self.proc.kill()
                    self.proc.wait(timeout=5)
                except Exception:
                    pass


def _connect(endpoint: str, timeout: float) -> socket.socket:
    host, _, port = endpoint.rpartition(":")
    sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                    timeout=timeout)
    sock.settimeout(timeout)
    return sock


def _drain(stream, tail: deque) -> None:
    """Keep a worker's last stderr lines (its error line when it fails
    to come up) without letting its pipe fill."""
    for raw in iter(stream.readline, b""):
        line = raw.decode("utf-8", "replace").rstrip()
        if line:
            tail.append(line)


def _spawn_worker(device: str, timeout: float):
    """Start a local worker process on an ephemeral port, its cells on
    `device` ("cpu", "cuda" for the first cards, or one named card).
    -> (proc, endpoint). Raises ValueError with the worker's own last
    error line when it does not come up."""
    import selectors
    import subprocess
    import sys

    env = dict(os.environ)
    # the worker serves slices: it never builds meshes or spawns
    # workers of its own off the coordinator's knobs
    env.pop("TRIVY_TPU_MESH", None)
    env.pop(ENV_DCN, None)
    # the worker imports this package from wherever the coordinator did,
    # whatever its working directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    # --parent-watch: the worker dies with us (stdin EOF) and honours
    # the shutdown op, both only in spawn mode
    proc = subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch.ops.dcn", "--worker",
         "--port", "0", "--parent-watch", "--device", str(device)],
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    tail: deque = deque(maxlen=40)
    # lint: allow[tracing-capture] stderr drainer of a spawned worker emits no spans; nothing to stitch
    drainer = threading.Thread(target=_drain, args=(proc.stderr, tail),
                               name="ttpu-dcn-stderr", daemon=True)
    drainer.start()
    # a deadline-bounded read of the readiness line: a wedged worker
    # fails engine construction at the timeout instead of blocking the
    # server's reload forever
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + timeout
    port = None
    buf = b""
    try:
        while time.monotonic() < deadline and port is None:
            if b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                if line.startswith(READY_LINE.encode()):
                    port = int(line.split(b"port=")[1].strip())
                continue
            if not sel.select(timeout=min(
                    1.0, max(deadline - time.monotonic(), 0.05))):
                if proc.poll() is not None:
                    break
                continue
            chunk = os.read(proc.stdout.fileno(), 4096)
            if not chunk:
                break
            buf += chunk
    finally:
        sel.close()
    if port is None:
        proc.kill()
        proc.wait(timeout=10)
        drainer.join(timeout=5)
        why = tail[-1] if tail else (
            f"no readiness line within {timeout:g} s")
        raise ValueError(f"DCN worker subprocess failed to come up: {why}")
    return proc, f"127.0.0.1:{port}"


def worker_stats(endpoint: str, reset: bool = False,
                 timeout: float = 30.0) -> dict:
    """A port worker's device, sessions and match-kernel launches
    (``reset``: zero the launch counts after reading them), on a
    connection of its own so no serving connection is touched. A
    reference worker does not know the op."""
    sock = _connect(endpoint, timeout)
    try:
        _send_msg(sock, {"op": "stats", "reset": int(reset), "rid": 1})
        reply, _ = _recv_msg(sock)
    finally:
        sock.close()
    if not reply.get("ok"):
        raise HostFault(f"worker {endpoint}: {reply.get('error')}")
    return reply


# ---------------------------------------------------------------- HostMeshDB


@dataclass
class HostPending:
    """An in-flight distributed match: the local slice's MeshPending and
    one request future per remote host. The ``engine.host`` ladder runs
    at collect time, so a lost in-flight result can be sent again or
    degraded to the host mask."""

    hmdb: "HostMeshDB"
    local: object  # ops/mesh.MeshPending | None
    remote: list   # [(host_index, _RemoteHost, Future | None)]
    arrays: dict   # the wire batch (sent again on drop / retry)
    b: int

    def collect(self) -> np.ndarray:
        from trivy_tpu_torch.ops import match as m

        h = self.hmdb
        w = m._words(h.window) * 32
        # the remote hosts were dispatched first and compute now;
        # collecting the local grid first keeps the overlap
        local_masks = self.local.collect() if self.local is not None \
            else np.zeros((h.db_local, self.b, w), dtype=bool)
        words_by_host = {idx: h._collect_host(host, fut, self.arrays,
                                              self.b)
                         for idx, host, fut in self.remote}
        # the host merge: per-host packed words unpack into the
        # [n_db, B, W] stack the engine's shard decoder reads (a
        # degraded host's slice is recomputed here as the host mask)
        t0 = time.perf_counter()
        with tracing.span("dcn.merge", hosts=h.n_hosts):
            masks = np.zeros((h.n_db, self.b, w), dtype=bool)
            masks[: h.db_local] = local_masks
            for idx, _host, _fut in self.remote:
                lo = idx * h.db_local
                words = words_by_host[idx]
                if words is None:
                    masks[lo: lo + h.db_local] = h._host_mask_block(
                        idx, self.arrays)
                else:
                    for j in range(h.db_local):
                        masks[lo + j] = m._unpack_words(words[j],
                                                        h.window)
        merge_s = time.perf_counter() - t0
        obs_metrics.DCN_MERGE_SECONDS.observe(merge_s)
        with h._lock:
            h.merges += 1
            h.merge_s += merge_s
        return masks


class HostMeshDB:
    """The distributed MeshDB the coordinator serves from: host 0's
    slice on a local ops/mesh.py grid (the whole ``engine.shard``
    ladder), hosts 1..H-1 behind the worker protocol. It has MeshDB's
    surface (dispatch, shard_base, shard_len, n_db, n_data, grid,
    health, reresolve), so the engine's decoder and the scheduler's
    composition probes read it unchanged."""

    def __init__(self, cdb, local_mdb, hosts: list[_RemoteHost],
                 n_hosts: int, db_local: int):
        from trivy_tpu_torch.ops import mesh as mesh_ops

        self.cdb = cdb
        self._local = local_mdb
        self.hosts = hosts
        self.n_hosts = n_hosts
        self.db_local = db_local
        self.n_db = n_hosts * db_local  # global shard count
        self.n_data = local_mdb.n_data
        self.window = local_mdb.window
        self.shard_len = local_mdb.shard_len
        self.shard_base = local_mdb.shard_base
        self.retries = mesh_ops.shard_retries()
        self.degraded_hosts: set[int] = set()
        # the reference's DCN metrics as plain counters
        self.degradations: dict[int, int] = {}
        self.host_retry_count: dict[int, int] = {}
        self.dispatches: dict[int, int] = {}
        self.dispatch_s: dict[int, float] = {}
        self.merges = 0
        self.merge_s = 0.0
        self.reresolves = 0
        self.build_stats: dict = {}
        # the device string a spawned worker gets (the coordinator's
        # placement), and the wire session
        self.worker_device = "cuda"
        self._session = ""
        self._lock = make_lock("ops.dcn.HostMeshDB._lock")
        self._closed = False
        # spawned workers die with the coordinator even if the owning
        # engine is never closed
        import atexit

        atexit.register(self.close)

    @property
    def grid(self):
        return self._local.grid

    @property
    def degraded(self):
        """Locally degraded GLOBAL shard indices (host 0's slice)."""
        return self._local.degraded

    # -------------------------------------------------------- construction

    @classmethod
    def from_compiled(cls, cdb, n_hosts: int, dp: int, db_local: int,
                      cache_ctx=None, device=None,
                      devices=None) -> "HostMeshDB":
        """Build the cross-host DB from a CompiledDB. The coordinator
        loads ONLY its own slice when the host-slice cache has it
        (`cache_ctx` = (db_path, digest, db_meta, requested_window));
        otherwise it cuts the whole table once, saves every host's entry
        and keeps the other slices just long enough to push them to cold
        workers. Its cells go on `devices` when given (dp*db_local of
        them), else on the first dp*db_local cards for a CUDA `device`
        (the default) or all on the CPU; a spawned worker gets the same
        placement."""
        from trivy_tpu_torch.ops import match as m
        from trivy_tpu_torch.ops import mesh as mesh_ops
        from trivy_tpu_torch.tensorize import cache as compile_cache

        kind = torch.device("cuda" if device is None else device).type
        cells = grid_devices(dp, db_local, torch.device(kind),
                             "coordinator", devices=devices)
        flat = [d for row in cells for d in row]
        worker_device = str(flat[0]) if devices is not None \
            and len(set(flat)) == 1 else kind
        stats: dict = {"host_cache": "off", "slice_s": 0.0, "save_s": 0.0,
                       "load_s": 0.0}
        n_db = n_hosts * db_local
        db_path = digest = db_meta = window_req = None
        if cache_ctx:
            db_path, digest, db_meta, window_req = cache_ctx
        use_cache = bool(db_path) and digest is not None \
            and compile_cache.enabled()
        own = None
        if use_cache:
            t0 = time.perf_counter()
            own = compile_cache.load_host_slice(
                db_path, digest=digest, window=window_req,
                db_meta=db_meta, n_hosts=n_hosts, host_index=0,
                n_db=n_db, n_rows=cdb.n_rows,
                resolved_window=cdb.window)
            stats["load_s"] = time.perf_counter() - t0
            stats["host_cache"] = "miss" if own is None else "hit"
        global_shards = None

        def cut():
            nonlocal global_shards
            if global_shards is None:
                t0 = time.perf_counter()
                global_shards = m.host_shards(cdb, n_db)
                stats["slice_s"] += time.perf_counter() - t0
            return global_shards

        if own is None:
            h1s, tables, shard_len, shard_base = cut()
            own = {"h1s": h1s[:db_local], "tables": tables[:db_local],
                   "shard_len": shard_len, "shard_base": shard_base}
            if use_cache:
                t0 = time.perf_counter()
                for h in range(n_hosts):
                    lo = h * db_local
                    compile_cache.save_host_slice(
                        db_path, digest=digest, window=window_req,
                        db_meta=db_meta, n_hosts=n_hosts, host_index=h,
                        n_db=n_db, n_rows=cdb.n_rows,
                        resolved_window=cdb.window,
                        shard_len=shard_len, shard_base=shard_base,
                        h1s=h1s[lo: lo + db_local],
                        tables=tables[lo: lo + db_local])
                stats["save_s"] = time.perf_counter() - t0

        shard_len = int(own["shard_len"])
        shard_base = int(own["shard_base"])
        t0 = time.perf_counter()
        grid = _build_grid(cells, own["h1s"], own["tables"], cdb.window)
        stats["upload_s"] = time.perf_counter() - t0
        # host 0's global shards ARE indices 0..db_local-1, so a MeshDB
        # over the local grid with the GLOBAL (base, len) partition runs
        # the whole engine.shard ladder as it is
        local = mesh_ops.MeshDB(
            cdb=cdb, grid=grid, devices=cells, n_data=dp, n_db=db_local,
            window=cdb.window, shard_len=shard_len, shard_base=shard_base,
            n_global=n_db)
        self = cls(cdb, local, [], n_hosts, db_local)
        self.worker_device = worker_device
        self.build_stats = stats
        timeout = dcn_timeout_s()
        workers = configured_workers()
        session = uuid.uuid4().hex
        hello = {
            "op": "hello", "session": session, "hosts": n_hosts,
            "n_db": n_db, "db_local": db_local, "dp": dp,
            "n_rows": int(cdb.n_rows), "window": int(cdb.window),
            "window_req": window_req, "shard_len": shard_len,
            "shard_base": shard_base,
            "digest": digest, "db_path": db_path, "db_meta": db_meta,
        }
        for key in ("spawn_s", "hello_s", "push_mb", "push_s"):
            stats[key] = []
        try:
            for h in range(1, n_hosts):
                t0 = time.perf_counter()
                if not isinstance(workers, list):
                    proc, endpoint = _spawn_worker(worker_device, timeout)
                    stats["spawn_s"].append(time.perf_counter() - t0)
                else:
                    proc, endpoint = None, workers[h - 1]
                sock = _connect(endpoint, timeout)
                host = _RemoteHost(h, endpoint=endpoint, proc=proc,
                                   sock=sock)
                self.hosts.append(host)
                t0 = time.perf_counter()
                reply, _ = host.request(
                    dict(hello, host_index=h)).result(timeout)
                stats["hello_s"].append(time.perf_counter() - t0)
                if reply.get("need_slice"):
                    h1s, tables, _sl, _sb = cut()
                    lo = h * db_local
                    arrays = {"h1s": h1s[lo: lo + db_local],
                              "tables": tables[lo: lo + db_local]}
                    t0 = time.perf_counter()
                    reply, _ = host.request(
                        {"op": "load", "session": session},
                        arrays=arrays).result(timeout)
                    stats["push_s"].append(time.perf_counter() - t0)
                    stats["push_mb"].append(
                        sum(a.nbytes for a in arrays.values()) / 1e6)
                host.info = {"endpoint": endpoint,
                             "source": reply.get("source", "push"),
                             "session": session}
        except Exception:
            self.close()
            raise
        self._session = session
        stats["sources"] = self.host_sources()
        obs_metrics.MESH_SHAPE.set(n_hosts, axis="hosts")
        obs_metrics.MESH_SHAPE.set(dp, axis="data")
        obs_metrics.MESH_SHAPE.set(n_db, axis="db")
        _log.info("distributed mesh DB resident", hosts=n_hosts,
                  data=dp, db_local=db_local, shard_rows=shard_len,
                  total_rows=cdb.n_rows, sources=stats["sources"])
        return self

    # ------------------------------------------------------------ dispatch

    def dispatch(self, batch) -> HostPending | None:
        """Launch a batch on every host without blocking: the remote
        requests go out first (their hosts compute while the local grid
        dispatches), then the local cells. None when there is no
        work."""
        b = len(batch.h1)
        if b == 0 or self.cdb.n_rows == 0:
            return None
        arrays = {
            "h1": np.ascontiguousarray(batch.h1),
            "h2": np.ascontiguousarray(batch.h2),
            "rank": np.ascontiguousarray(batch.rank),
            "flags": np.ascontiguousarray(batch.flags),
        }
        with self._lock:
            degraded = set(self.degraded_hosts)
        remote = [(host.idx, host, None if host.idx in degraded
                   else self._send_match(host, arrays, b))
                  for host in self.hosts]
        local = self._local.dispatch(batch)
        return HostPending(hmdb=self, local=local, remote=remote,
                           arrays=arrays, b=b)

    def _send_match(self, host: _RemoteHost, arrays: dict,
                    b: int) -> Future:
        return host.request(
            {"op": "match", "b": b, "session": self._session}, arrays)

    # ------------------------------------------------------------- collect

    def _host_mask_block(self, host_idx: int, arrays: dict) -> np.ndarray:
        """bool[db_local, B, W]: a degraded host's slice as the host
        mask, the match kernel's plain version over each global shard
        the host owns (ops/mesh.py MeshDB._host_mask, whose partition is
        the global one)."""
        from trivy_tpu_torch.ops import match as m

        b = len(arrays["h1"])
        sub = m.PackageBatch(h1=arrays["h1"], h2=arrays["h2"],
                             rank=arrays["rank"], flags=arrays["flags"],
                             queries=[None] * b)
        return np.stack([self._local._host_mask(
            host_idx * self.db_local + j, sub)
            for j in range(self.db_local)])

    def _degrade_host(self, idx: int, exc: Exception) -> None:
        with self._lock:
            fresh = idx not in self.degraded_hosts
            self.degraded_hosts.add(idx)
            if fresh:
                self.degradations[idx] = self.degradations.get(idx, 0) + 1
        if fresh:
            obs_metrics.DCN_HOST_DEGRADATIONS.inc(host=str(idx))
            _log.warn(
                "DCN host degraded: its advisory slice now serves from "
                "the coordinator's host mask (the other hosts keep "
                "serving on their devices; zero finding diff)",
                host=idx, err=str(exc))

    def _collect_host(self, host: _RemoteHost, fut,
                      arrays: dict, b: int) -> np.ndarray | None:
        """Block on one remote host's packed words, running the
        ``engine.host`` ladder: drop -> send again, error -> retry then
        degrade, device-lost -> degrade now. None when the host is (now)
        degraded: the caller recomputes its slice as the host mask. A
        worker's device error raises."""
        t0 = time.perf_counter()
        # the cross-host wait: where the coordinator blocks on a peer's
        # card and the round trip
        with tracing.span("engine.host", host=host.idx):
            try:
                return self._collect_host_timed(host, fut, arrays, b)
            finally:
                seconds = time.perf_counter() - t0
                obs_metrics.DCN_HOST_DISPATCH_SECONDS.observe(
                    seconds, host=str(host.idx))
                with self._lock:
                    self.dispatches[host.idx] = \
                        self.dispatches.get(host.idx, 0) + 1
                    self.dispatch_s[host.idx] = self.dispatch_s.get(
                        host.idx, 0.0) + seconds

    def _collect_host_timed(self, host, fut, arrays, b):
        with self._lock:
            if host.idx in self.degraded_hosts:
                return None
        if fut is None:
            return None
        timeout = dcn_timeout_s()
        attempt = 0
        while True:
            try:
                redo = fut is None
                for r in faults.fire("engine.host"):
                    if r.action == "delay":
                        time.sleep(r.param if r.param is not None
                                   else 0.02)
                    elif r.action == "drop":
                        redo = True
                    elif r.action == "error":
                        raise HostFault(
                            f"injected host error (host {host.idx})")
                    elif r.action == "device-lost":
                        raise HostLost(
                            f"injected host loss (host {host.idx})")
                if redo:
                    # a dropped in-flight result is recomputed on the
                    # worker: the match set stays the same
                    fut = self._send_match(host, arrays, b)
                _reply, rarrays = fut.result(timeout)
                words = rarrays.get("words")
                if words is None or words.ndim != 3 \
                        or words.shape[:2] != (self.db_local, b):
                    raise HostFault(
                        f"host {host.idx} returned mask shape "
                        f"{None if words is None else words.shape}, "
                        f"want ({self.db_local}, {b}, _)")
                return words.astype(np.uint32, copy=False)
            except (HostLost, faults.DeviceLost) as exc:
                self._degrade_host(host.idx, exc)
                return None
            except (HostFault, OSError) as exc:
                # OSError: a closed or reset connection, a socket or
                # reply timeout (TimeoutError), a correlation mismatch
                if attempt >= self.retries:
                    self._degrade_host(host.idx, exc)
                    return None
                attempt += 1
                with self._lock:
                    self.host_retry_count[host.idx] = \
                        self.host_retry_count.get(host.idx, 0) + 1
                _log.warn("DCN host dispatch failed; retrying",
                          host=host.idx, attempt=attempt, err=str(exc))
                fut = None  # sent again on the next pass

    # ----------------------------------------------------------- reresolve

    def reresolve(self) -> bool:
        """Re-resolve the topology over the SURVIVING hosts. A host's
        degradation is one way while serving, so recovery is this
        explicit decision: re-partition the table into (1 + survivors)
        * db_local global shards, rebuild the coordinator's local grid
        on the same devices, and hello every surviving worker into a
        fresh session (the old session answers in-flight batches until
        it is evicted; callers quiesce first, as the server's write lock
        does). Nothing changes until every survivor acknowledged its new
        slice, so a failed re-resolve leaves the old topology serving.
        Returns True when the topology changed (or, with no degraded
        host, when the local mesh restored a degraded shard)."""
        from trivy_tpu_torch.ops import match as m
        from trivy_tpu_torch.ops import mesh as mesh_ops

        with self._lock:
            dead_idx = set(self.degraded_hosts)
        if not dead_idx:
            # no host lost: shard-level recovery on the local slice
            return self._local.reresolve()
        survivors = [h for h in self.hosts if h.idx not in dead_idx]
        dead = [h for h in self.hosts if h.idx in dead_idx]
        n_hosts = 1 + len(survivors)
        dp, db_local = self.n_data, self.db_local
        n_db = n_hosts * db_local
        timeout = dcn_timeout_s()
        session = uuid.uuid4().hex
        h1s, tables, shard_len, shard_base = m.host_shards(self.cdb, n_db)
        cells = self._local.devices
        try:
            grid = _build_grid(cells, h1s[:db_local], tables[:db_local],
                               self.window)
        except Exception as exc:
            raise DeviceError(
                "the coordinator's slice upload failed: "
                f"{type(exc).__name__}: {exc}") from exc
        local = mesh_ops.MeshDB(
            cdb=self.cdb, grid=grid, devices=cells, n_data=dp,
            n_db=db_local, window=self.window, shard_len=shard_len,
            shard_base=shard_base, n_global=n_db)
        hello = {
            "op": "hello", "session": session, "hosts": n_hosts,
            "n_db": n_db, "db_local": db_local, "dp": dp,
            "n_rows": int(self.cdb.n_rows),
            "window": int(self.window), "window_req": None,
            "shard_len": shard_len, "shard_base": shard_base,
            "digest": None, "db_path": None, "db_meta": None,
        }
        # re-slicing moved every shard's rows, so the slices are always
        # pushed (the host-slice cache keys the OLD topology)
        for new_idx, host in enumerate(survivors, start=1):
            reply, _ = host.request(
                dict(hello, host_index=new_idx)).result(timeout)
            if reply.get("need_slice"):
                lo = new_idx * db_local
                reply, _ = host.request(
                    {"op": "load", "session": session},
                    arrays={"h1s": h1s[lo: lo + db_local],
                            "tables": tables[lo: lo + db_local]},
                ).result(timeout)
        with self._lock:
            for new_idx, host in enumerate(survivors, start=1):
                host.idx = new_idx
                host.info = dict(host.info, session=session,
                                 source="push")
            self.hosts = survivors
            self.n_hosts = n_hosts
            self.n_db = n_db
            self._local = local
            self.shard_len = shard_len
            self.shard_base = shard_base
            self._session = session
            self.degraded_hosts = set()
            self.reresolves += 1
        for h in dead:
            h.close()
        obs_metrics.MESH_SHAPE.set(n_hosts, axis="hosts")
        obs_metrics.MESH_SHAPE.set(n_db, axis="db")
        obs_metrics.MESH_RERESOLVES.inc(scope="host")
        _log.info("cross-host mesh re-resolved over the surviving hosts",
                  hosts=n_hosts, db=n_db, dropped=sorted(dead_idx),
                  shard_rows=shard_len)
        return True

    # -------------------------------------------------------------- health

    def health(self) -> dict:
        """The topology HOSTSxDPxDB, the local slice's degraded shards
        (``degraded``, global indices, the single-host mesh's key) and
        ``degraded_hosts`` (peers whose whole slice serves from the
        coordinator's host mask): what /readyz and ready_doc read."""
        local = self._local.health()
        with self._lock:
            dh = sorted(self.degraded_hosts)
        return {
            "shape": f"{self.n_hosts}x{self.n_data}x{self.db_local}",
            "data": self.n_data,
            "db": self.n_db,
            "degraded": local["degraded"],
            "hosts": self.n_hosts,
            "degraded_hosts": dh,
        }

    def host_sources(self) -> list[str]:
        """Where each remote host's slice came from: "cache" (its
        host-slice entry) or "push" (sent over the wire)."""
        return [h.info.get("source", "?") for h in self.hosts]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        import atexit

        try:
            atexit.unregister(self.close)
        except Exception:
            pass
        for h in self.hosts:
            h.close()


# -------------------------------------------------------------- worker side


def _build_grid(devices, h1s: np.ndarray, tables: np.ndarray,
                window: int):
    """[dp][db_local] DeviceDB grid, cell (g, j) holding slice j on
    devices[g][j]: the ONE placement loop of the coordinator (its global
    shards 0..db_local-1) and of every worker (its run of the same
    partition). On a card it loads the match kernel too, so a cold
    kernel build lands here and not in the first match."""
    from trivy_tpu_torch.ops import match as m

    grid = [[m.shard_device_db(h1s[j], tables[j], window, dev)
             for j, dev in enumerate(row)] for row in devices]
    if any(dev.type == "cuda" for row in devices for dev in row):
        from trivy_tpu_torch.ops import kernels

        kernels.load("match")
    return grid


class _WorkerState:
    """The worker's resident slices, by session. Up to MAX_SESSIONS stay
    resident, so a server's hot reload (whose successor engine hellos
    BEFORE the old one is swapped out and closed) never evicts the live
    engine's slice mid-scan: the oldest session goes only when a third
    arrives."""

    MAX_SESSIONS = 2

    def __init__(self, device: torch.device, boot: dict | None = None):
        from collections import OrderedDict

        self.device = device
        # where the process's start went, for the stats op
        self.boot = boot or {}
        self.lock = threading.Lock()
        # session -> {"grid": [dp][db_local] DeviceDB, "meta": dict}
        self.sessions: "OrderedDict[str, dict]" = OrderedDict()
        # session -> hello meta awaiting its pushed slice
        self.pending: dict[str, dict] = {}

    def insert(self, session: str, grid, meta: dict) -> None:
        """Caller holds self.lock."""
        self.sessions[session] = {"grid": grid, "meta": meta}
        self.sessions.move_to_end(session)
        while len(self.sessions) > self.MAX_SESSIONS:
            self.sessions.popitem(last=False)


def _worker_build_grid(state: _WorkerState, meta: dict, h1s: np.ndarray,
                       tables: np.ndarray):
    cells = grid_devices(int(meta["dp"]), int(meta["db_local"]),
                         state.device, "worker")
    return _build_grid(cells, h1s, tables, int(meta["window"]))


def _worker_hello(state: _WorkerState, h: dict) -> dict:
    """(Re)load this worker's slice for the hello'd session: the
    host-slice entry when the coordinator names an on-disk DB, else ask
    for a push. The digest and db_meta cross-checks are those of the
    coordinator's own cache loads."""
    from trivy_tpu_torch.tensorize import cache as compile_cache

    with state.lock:
        resident = state.sessions.get(h["session"])
        if resident is not None:
            state.sessions.move_to_end(h["session"])
            return {"ok": 1,
                    "source": resident["meta"].get("source", "?")}
    # the cache probe and the upload happen OUTSIDE the lock: a hot-swap
    # successor's upload must not stall the live session's matches
    entry = None
    if h.get("db_path") and h.get("digest") \
            and compile_cache.enabled():
        entry = compile_cache.load_host_slice(
            h["db_path"], digest=h["digest"],
            window=h.get("window_req"), db_meta=h.get("db_meta"),
            n_hosts=int(h["hosts"]), host_index=int(h["host_index"]),
            n_db=int(h["n_db"]), n_rows=int(h["n_rows"]),
            resolved_window=int(h["window"]))
    if entry is not None \
            and (int(entry["shard_len"]) != int(h["shard_len"])
                 or int(entry["shard_base"]) != int(h["shard_base"])):
        entry = None
    if entry is None:
        with state.lock:
            # the follow-up load binds to this hello
            state.pending[h["session"]] = dict(h, source="push")
        return {"ok": 1, "need_slice": 1}
    try:
        grid = _worker_build_grid(state, h, entry["h1s"], entry["tables"])
    except Exception as exc:
        return {"ok": 0, "device_error": 1,
                "error": f"{type(exc).__name__}: {exc}"}
    with state.lock:
        state.insert(h["session"], grid, dict(h, source="cache"))
    return {"ok": 1, "source": "cache"}


def _worker_load(state: _WorkerState, h: dict, arrays: dict) -> dict:
    from trivy_tpu_torch.tensorize import cache as compile_cache

    with state.lock:
        meta = state.pending.pop(h.get("session"), None)
    if meta is None:
        return {"ok": 0, "error": "load without a matching hello"}
    # the upload outside the lock (see _worker_hello); a failed upload
    # is the device's, marked for the coordinator to raise
    try:
        grid = _worker_build_grid(state, meta, arrays["h1s"],
                                  arrays["tables"])
    except Exception as exc:
        return {"ok": 0, "device_error": 1,
                "error": f"{type(exc).__name__}: {exc}"}
    with state.lock:
        state.insert(meta["session"], grid, meta)
    # save the pushed slice so this worker's NEXT start loads it from
    # the host-slice cache (best effort)
    if meta.get("db_path") and meta.get("digest"):
        compile_cache.save_host_slice(
            meta["db_path"], digest=meta["digest"],
            window=meta.get("window_req"),
            db_meta=meta.get("db_meta"),
            n_hosts=int(meta["hosts"]),
            host_index=int(meta["host_index"]),
            n_db=int(meta["n_db"]), n_rows=int(meta["n_rows"]),
            resolved_window=int(meta["window"]),
            shard_len=int(meta["shard_len"]),
            shard_base=int(meta["shard_base"]),
            h1s=arrays["h1s"], tables=arrays["tables"])
    return {"ok": 1, "source": "push"}


def _worker_match(state: _WorkerState, h: dict,
                  arrays: dict) -> tuple[dict, dict]:
    """The session's cells each match their data group's rows: ->
    uint32[db_local, B, W/32] packed words. A failure of the device work
    is marked ``device_error`` for the coordinator to raise."""
    from trivy_tpu_torch.ops import match as m

    with state.lock:
        resident = state.sessions.get(h.get("session"))
        if resident is None:
            return {"ok": 0, "error": "stale-slice"}, {}
        state.sessions.move_to_end(h["session"])
        grid = resident["grid"]
        meta = resident["meta"]
    dp = int(meta["dp"])
    db_local = int(meta["db_local"])
    b = int(h["b"])
    h1, h2 = arrays["h1"], arrays["h2"]
    rank, flags = arrays["rank"], arrays["flags"]
    out = np.zeros((db_local, b, m._words(int(meta["window"]))),
                   dtype=np.uint32)
    base, rem = divmod(b, dp)
    try:
        pend = []
        lo = 0
        for g in range(dp):
            hi = lo + base + (1 if g < rem else 0)
            if hi == lo:
                continue
            sub = m.PackageBatch(
                h1=h1[lo:hi], h2=h2[lo:hi], rank=rank[lo:hi],
                flags=flags[lo:hi], queries=[None] * (hi - lo))
            for j in range(db_local):
                pend.append((j, lo, hi, m.match_dispatch(grid[g][j], sub)))
            lo = hi
        for j, glo, ghi, p in pend:
            if p is not None:
                out[j, glo:ghi] = p.collect_words()
    except Exception as exc:
        return {"ok": 0, "device_error": 1,
                "error": f"{type(exc).__name__}: {exc}"}, {}
    return {"ok": 1}, {"words": out}


def _worker_stats(state: _WorkerState, h: dict) -> dict:
    """The worker's device; per resident session its cells' devices and
    match-kernel launches; the wrapper's total launches; whether the
    process loaded jax or the JAX package (it must not)."""
    import sys

    from trivy_tpu_torch.ops import match as m

    with state.lock:
        sessions = {
            sid: {"cells": [[str(ddb.device) for ddb in row]
                            for row in s["grid"]],
                  "launches": [[ddb.launches for ddb in row]
                               for row in s["grid"]]}
            for sid, s in state.sessions.items()}
        total = m.match_words.launches
        if h.get("reset"):
            m.match_words.launches = 0
            for s in state.sessions.values():
                for row in s["grid"]:
                    for ddb in row:
                        ddb.launches = 0
    loaded = list(sys.modules)
    return {"ok": 1, "pid": os.getpid(), "device": str(state.device),
            "boot": state.boot, "sessions": sessions, "launches": total,
            "jax": any(n == "jax" or n.startswith("jax.") for n in loaded),
            "trivy_tpu": any(n == "trivy_tpu" or n.startswith("trivy_tpu.")
                             for n in loaded)}


def _serve_conn(conn: socket.socket, state: _WorkerState,
                allow_shutdown: bool) -> None:
    try:
        while True:
            header, arrays = _recv_msg(conn)
            op = header.get("op")
            if op == "shutdown":
                # only a spawned worker (loopback, owned by its
                # coordinator) honours shutdown; a standalone worker is
                # not killable by one frame from whatever reaches it
                if allow_shutdown:
                    os._exit(0)
                _send_msg(conn, {"ok": 0, "rid": header.get("rid"),
                                 "error": "shutdown not allowed on a "
                                          "standalone worker"})
                continue
            try:
                if op == "hello":
                    reply, rarrays = _worker_hello(state, header), {}
                elif op == "load":
                    reply, rarrays = _worker_load(state, header,
                                                  arrays), {}
                elif op == "match":
                    reply, rarrays = _worker_match(state, header, arrays)
                elif op == "ping":
                    reply, rarrays = {"ok": 1}, {}
                elif op == "stats":
                    reply, rarrays = _worker_stats(state, header), {}
                else:
                    reply, rarrays = {"ok": 0,
                                      "error": f"unknown op {op!r}"}, {}
            except Exception as exc:
                reply, rarrays = {"ok": 0, "error": str(exc)}, {}
            reply["rid"] = header.get("rid")  # correlation echo
            _send_msg(conn, reply, rarrays or None)
    except (ConnectionError, OSError):
        pass  # the coordinator went away; wait for the next connection
    finally:
        try:
            conn.close()
        except OSError:
            pass


def _watch_stdin() -> None:
    """Exit when the spawning coordinator dies: its stdin pipe reaches
    EOF. Spawn mode only (``--parent-watch``): a standalone worker
    daemonized with stdin at EOF must NOT exit on this."""
    import sys

    try:
        while sys.stdin.buffer.read(1 << 16):
            pass
    except Exception:
        pass
    os._exit(0)


def _process_age_s() -> float | None:
    """Seconds since this process started (Linux /proc), else None."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return up - ticks / os.sysconf("SC_CLK_TCK")


def _worker_device(spec: str | None) -> torch.device:
    """The worker's device: "cpu", "cuda" (the first cards a session
    needs), "cuda:N" (every cell on card N); none means "cuda". The
    card's context is made here, before the readiness line."""
    dev = torch.device(spec or "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {spec!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to serve from the "
            "CPU")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {index}: the host has "
                           f"{torch.cuda.device_count()}")
    torch.zeros(1, device=torch.device("cuda", index))
    return dev


def worker_main(argv: list[str]) -> int:
    """``python -m trivy_tpu_torch.ops.dcn --worker [--port N] [--bind
    ADDR] [--parent-watch] [--device D]``: serve this host's advisory
    slice to a coordinator. Prints exactly ``DCN_WORKER_READY port=N``
    once listening. Binds loopback by default (spawn mode, one box); a
    worker serving a remote coordinator passes ``--bind 0.0.0.0`` (or
    its interconnect's address) and belongs on a private network: the
    slice protocol is a data plane, not a public surface.
    ``--parent-watch`` (spawn mode) ties the worker's life to the
    coordinator's stdin pipe and enables the ``shutdown`` op. A worker
    that cannot use its device prints one error line and exits 1."""
    import sys

    port = 0
    bind = "127.0.0.1"
    device = None
    if "--port" in argv:
        port = int(argv[argv.index("--port") + 1])
    if "--bind" in argv:
        bind = argv[argv.index("--bind") + 1]
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    parent_watch = "--parent-watch" in argv
    # the interpreter's start and imports, then the device's context
    boot = {"imports_s": _process_age_s()}
    t0 = time.perf_counter()
    try:
        dev = _worker_device(device)
        boot["device_s"] = time.perf_counter() - t0
        state = _WorkerState(dev, boot)
    except (RuntimeError, ValueError) as exc:
        print(f"DCN worker: {exc}", file=sys.stderr, flush=True)
        return 1
    srv = socket.create_server((bind, port))
    print(f"{READY_LINE}{srv.getsockname()[1]}", flush=True)
    if parent_watch:
        # lint: allow[tracing-capture] parent-death watchdog in the worker process; no tracing spine on this side
        threading.Thread(target=_watch_stdin, daemon=True).start()
    while True:
        conn, _addr = srv.accept()
        # lint: allow[tracing-capture] worker process serves raw slices; no tracing spine on this side
        threading.Thread(target=_serve_conn,
                         args=(conn, state, parent_watch),
                         daemon=True).start()


def main(argv: list[str]) -> int:
    if "--worker" in argv:
        return worker_main(argv)
    print("usage: python -m trivy_tpu_torch.ops.dcn --worker [--port N] "
          "[--bind ADDR] [--parent-watch] [--device D]")
    return 2


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
