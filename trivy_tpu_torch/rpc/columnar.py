"""Binary columnar wire format for the public RPC surface
(docs/performance.md "Binary columnar wire").

Promotes a DCN framing idiom (length-prefixed npz frames) to a
negotiated ``application/x-trivy-columnar`` content type on the twirp
paths: the hot documents — PkgQuery / package lists, MissingBlobs
digest lists, the scan response's finding tables — travel as dense
string columns (one shared UTF-8 buffer + a length column per field)
inside per-frame npz payloads, while cold metadata rides a JSON
envelope frame.  Decoding a column is one buffer decode plus a tight
slice loop instead of a per-dict ``json.loads`` + ``from_dict`` walk,
and ``decode_queries`` feeds ``detector/engine.encode_packages``
directly through the bulk ``queries_from_columns`` constructor.

Stream layout::

    MAGIC  frame  frame ...  end-frame
    frame := <I header_len> header_json payload
    header := {"k": kind, "b": len(payload), "crc": crc32(payload),
               "z": 0|1 (payload deflated), ...kind-specific meta}

Every frame carries a CRC-32 of its payload: a corrupt frame is a
deterministic :class:`WireFormatError` at either end (the ``rpc.wire``
fault ladder's ``corrupt`` action — the receiver rejects and the
client resends JSON, docs/resilience.md).

Negotiation mirrors the gzip ladder (rpc/wire.py): the client
OFFERS via ``Accept: application/x-trivy-columnar``, the server
answers columnar-capable clients with columnar frames and advertises
its own capability with the ``X-Trivy-Columnar`` response header,
after which the client encodes REQUEST bodies columnar too.  Ends
that send no headers keep today's JSON(+gzip) bytes byte-identically,
and any 4xx to a columnar request from a server NOT advertising the
capability unlearns it (a rolled-back replica keeps serving JSON).
``TRIVY_TPU_WIRE=0`` is the kill switch at either end.

Zero diff: every decoder reconstructs the exact objects the JSON path
builds (golden-tested in tests/test_wire.py — re-encoding a decoded
columnar response through ``wire.scan_response`` yields the JSON
wire's bytes).

Copy of trivy_tpu/rpc/columnar.py. ``decode_queries`` feeds the port's
``detector/engine.queries_from_columns``.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

import numpy as np

from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.rpc import wire
from trivy_tpu_torch.types.artifact import OS, Layer, PkgIdentifier
from trivy_tpu_torch.types.enums import Status
from trivy_tpu_torch.types.report import (
    DataSource,
    DetectedVulnerability,
    Result,
    VulnerabilityInfo,
)
from trivy_tpu_torch.types.scan import ScanOptions
from trivy_tpu_torch.types.serde import from_dict

MAGIC = b"TCOL1\n"
CONTENT_TYPE = "application/x-trivy-columnar"
# server capability advertisement: its presence on any response tells
# the client that columnar REQUEST bodies are understood (the gzip
# negotiation pattern; absence on an error unlearns the capability)
CAPABLE_HEADER = "X-Trivy-Columnar"

ENV_KILL = "TRIVY_TPU_WIRE"

# frame payloads at or above this many bytes deflate (per frame, so a
# streamed response stays frame-at-a-time decodable); columnar bodies
# skip the whole-body gzip rung — compression is per frame here
DEFLATE_MIN_BYTES = 1024


def enabled() -> bool:
    """TRIVY_TPU_WIRE=0 is the kill switch at either end: the client
    stops offering and encoding columnar, the server stops advertising
    and accepting it — the exact pre-columnar JSON wire."""
    return os.environ.get(ENV_KILL, "1") != "0"


class WireFormatError(Exception):
    """Deterministic columnar decode failure (bad magic, truncated
    frame, CRC mismatch): the receiver rejects the body and the
    sender's ladder falls back to JSON."""


# ------------------------------------------------------------- framing


def _frame(kind: str, payload: bytes = b"", **meta) -> bytes:
    z = 0
    if len(payload) >= DEFLATE_MIN_BYTES:
        packed = zlib.compress(payload, 6)
        if len(packed) < len(payload):
            payload, z = packed, 1
    header = {"k": kind, "b": len(payload),
              "crc": zlib.crc32(payload) & 0xFFFFFFFF, "z": z}
    header.update(meta)
    hb = json.dumps(header, ensure_ascii=False).encode()
    obs_metrics.WIRE_FRAMES.inc(direction="out")
    return struct.pack("<I", len(hb)) + hb + payload


def frames(buf: bytes):
    """Demux `buf` -> yields (header, payload) per frame, CRC-checked,
    ending after (and including) the ``end`` frame."""
    if not buf.startswith(MAGIC):
        raise WireFormatError(
            f"bad columnar magic {buf[:len(MAGIC)]!r}")
    pos = len(MAGIC)
    n = len(buf)
    while True:
        if pos + 4 > n:
            raise WireFormatError("truncated columnar stream "
                                  "(missing end frame)")
        (hlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if pos + hlen > n:
            raise WireFormatError("truncated columnar frame header")
        try:
            header = json.loads(buf[pos:pos + hlen])
        except (ValueError, UnicodeDecodeError) as exc:
            raise WireFormatError(
                f"bad columnar frame header: {exc}") from exc
        pos += hlen
        blen = int(header.get("b", 0))
        if pos + blen > n:
            raise WireFormatError("truncated columnar frame payload")
        payload = buf[pos:pos + blen]
        pos += blen
        if (zlib.crc32(payload) & 0xFFFFFFFF) != header.get("crc"):
            raise WireFormatError(
                f"columnar frame checksum mismatch (kind "
                f"{header.get('k')!r})")
        if header.get("z"):
            try:
                payload = zlib.decompress(payload)
            except zlib.error as exc:
                raise WireFormatError(
                    f"bad columnar frame deflate: {exc}") from exc
        obs_metrics.WIRE_FRAMES.inc(direction="in")
        yield header, payload
        if header.get("k") == "end":
            return


# ------------------------------------------------------------- columns


def _pack_cols(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_cols(payload: bytes):
    try:
        return np.load(io.BytesIO(payload), allow_pickle=False)
    except (ValueError, OSError) as exc:
        raise WireFormatError(f"bad columnar payload: {exc}") from exc


def _put_str(arrays: dict, name: str, values: list[str]) -> None:
    """One string column = a shared UTF-8 buffer + per-row character
    lengths — npz-safe (no object arrays / pickle) and decoded with
    one buffer decode plus a slice loop."""
    text = "".join(values)
    arrays[name + "__u8"] = np.frombuffer(
        text.encode("utf-8"), dtype=np.uint8)
    arrays[name + "__len"] = np.asarray(
        [len(v) for v in values], dtype=np.uint32)


def _get_str(z, name: str) -> list[str]:
    try:
        text = z[name + "__u8"].tobytes().decode("utf-8")
        lens = z[name + "__len"].tolist()
    except KeyError as exc:
        raise WireFormatError(f"missing column {name!r}") from exc
    out = []
    pos = 0
    for ln in lens:
        nxt = pos + ln
        out.append(text[pos:nxt])
        pos = nxt
    return out


def _put_json_col(arrays: dict, name: str, values: list) -> None:
    """Per-row JSON column for rare/deep fields ("" = empty row) —
    the cold remainder of an otherwise flat table."""
    _put_str(arrays, name, [
        json.dumps(v, ensure_ascii=False) if v else "" for v in values])


def _get_json_col(z, name: str) -> list:
    return [json.loads(v) if v else None for v in _get_str(z, name)]


_LIST_SEP = "\n"


def _put_list_col(arrays: dict, name: str, values: list[list[str]],
                  spill: list[dict], field: str) -> None:
    """Newline-joined short string lists (CWE ids, reference URLs,
    vendor ids).  A row whose entries contain the separator spills to
    the row's ``rest`` JSON instead — exactness over compactness."""
    flat = []
    for i, row in enumerate(values):
        if any(_LIST_SEP in v for v in row):
            spill[i][field] = row
            flat.append("")
        else:
            flat.append(_LIST_SEP.join(row))
    _put_str(arrays, name, flat)


def _get_list_col(z, name: str) -> list[list[str]]:
    return [v.split(_LIST_SEP) if v else [] for v in _get_str(z, name)]


# ----------------------------------------------------- vulnerability table

_VULN_STR = (
    "vulnerability_id", "pkg_id", "pkg_name", "pkg_path",
    "installed_version", "fixed_version", "severity_source",
    "primary_url",
)
_PKG_ID_STR = ("purl", "uid", "bom_ref")
_LAYER_STR = ("digest", "diff_id", "created_by")
_DS_STR = ("id", "name", "url", "base_id")
_INFO_STR = ("title", "description", "severity", "published_date",
             "last_modified_date")


def _vuln_table(vulns: list[DetectedVulnerability],
                env: dict | None = None) -> bytes:
    """Vulnerability columns (+ the result's cold metadata as a JSON
    byte column, so big package lists ride INSIDE the deflated frame
    payload rather than the uncompressed frame header)."""
    n = len(vulns)
    arrays: dict = {"n": np.asarray([n], dtype=np.int64)}
    spill: list[dict] = [{} for _ in range(n)]
    for f in _VULN_STR:
        _put_str(arrays, f, [getattr(v, f) for v in vulns])
    arrays["status"] = np.asarray(
        [int(v.status) for v in vulns], dtype=np.int16)
    for f in _PKG_ID_STR:
        _put_str(arrays, "pi_" + f,
                 [getattr(v.pkg_identifier, f) for v in vulns])
    for f in _LAYER_STR:
        _put_str(arrays, "ly_" + f, [getattr(v.layer, f) for v in vulns])
    arrays["has_ds"] = np.asarray(
        [v.data_source is not None for v in vulns], dtype=np.uint8)
    for f in _DS_STR:
        _put_str(arrays, "ds_" + f,
                 [getattr(v.data_source, f) if v.data_source else ""
                  for v in vulns])
    arrays["has_info"] = np.asarray(
        [v.info is not None for v in vulns], dtype=np.uint8)
    for f in _INFO_STR:
        _put_str(arrays, "in_" + f,
                 [getattr(v.info, f) if v.info else "" for v in vulns])
    _put_list_col(arrays, "in_cwe_ids",
                  [v.info.cwe_ids if v.info else [] for v in vulns],
                  spill, "in_cwe_ids")
    _put_list_col(arrays, "in_references",
                  [v.info.references if v.info else [] for v in vulns],
                  spill, "in_references")
    _put_json_col(arrays, "in_vendor_severity",
                  [v.info.vendor_severity if v.info else None
                   for v in vulns])
    _put_json_col(arrays, "in_cvss",
                  [v.info.cvss if v.info else None for v in vulns])
    _put_list_col(arrays, "vendor_ids",
                  [v.vendor_ids for v in vulns], spill, "vendor_ids")
    _put_json_col(arrays, "rest", spill)
    if env:
        arrays["env__u8"] = np.frombuffer(
            json.dumps(env, ensure_ascii=False).encode(),
            dtype=np.uint8)
    return _pack_cols(arrays)


def _vulns_from_table(
        payload: bytes) -> tuple[list[DetectedVulnerability], dict]:
    z = _load_cols(payload)
    try:
        n = int(z["n"][0])
        status = z["status"].tolist()
        has_ds = z["has_ds"].tolist()
        has_info = z["has_info"].tolist()
    except KeyError as exc:
        raise WireFormatError(f"missing column {exc}") from exc
    cols = {f: _get_str(z, f) for f in _VULN_STR}
    pi = {f: _get_str(z, "pi_" + f) for f in _PKG_ID_STR}
    ly = {f: _get_str(z, "ly_" + f) for f in _LAYER_STR}
    ds = {f: _get_str(z, "ds_" + f) for f in _DS_STR}
    info = {f: _get_str(z, "in_" + f) for f in _INFO_STR}
    cwe = _get_list_col(z, "in_cwe_ids")
    refs = _get_list_col(z, "in_references")
    vsev = _get_json_col(z, "in_vendor_severity")
    cvss = _get_json_col(z, "in_cvss")
    vids = _get_list_col(z, "vendor_ids")
    rest = _get_json_col(z, "rest")
    out: list[DetectedVulnerability] = []
    for i in range(n):
        extra = rest[i] or {}
        out.append(DetectedVulnerability(
            vulnerability_id=cols["vulnerability_id"][i],
            vendor_ids=extra.get("vendor_ids", vids[i]),
            pkg_id=cols["pkg_id"][i],
            pkg_name=cols["pkg_name"][i],
            pkg_path=cols["pkg_path"][i],
            pkg_identifier=PkgIdentifier(
                purl=pi["purl"][i], uid=pi["uid"][i],
                bom_ref=pi["bom_ref"][i]),
            installed_version=cols["installed_version"][i],
            fixed_version=cols["fixed_version"][i],
            status=Status(status[i]),
            layer=Layer(digest=ly["digest"][i], diff_id=ly["diff_id"][i],
                        created_by=ly["created_by"][i]),
            severity_source=cols["severity_source"][i],
            primary_url=cols["primary_url"][i],
            data_source=DataSource(
                id=ds["id"][i], name=ds["name"][i], url=ds["url"][i],
                base_id=ds["base_id"][i]) if has_ds[i] else None,
            info=VulnerabilityInfo(
                title=info["title"][i],
                description=info["description"][i],
                severity=info["severity"][i],
                cwe_ids=extra.get("in_cwe_ids", cwe[i]),
                vendor_severity=vsev[i] or {},
                cvss=cvss[i] or {},
                references=extra.get("in_references", refs[i]),
                published_date=info["published_date"][i],
                last_modified_date=info["last_modified_date"][i],
            ) if has_info[i] else None,
        ))
    env = (json.loads(z["env__u8"].tobytes().decode("utf-8"))
           if "env__u8" in z else {})
    return out, env


# -------------------------------------------------------- scan response


def scan_response_frames(results: list[Result], os_found: OS):
    """Frame-by-frame scan-response encoder: the server writes (and
    flushes) each yielded chunk as its own HTTP chunk, so the client
    demuxes result K while result K+1 is still encoding."""
    env = {"os": wire._jsonable(os_found), "n_results": len(results)}
    yield MAGIC + _frame("env",
                         json.dumps(env, ensure_ascii=False).encode())
    for r in results:
        meta = {f: wire._jsonable(getattr(r, f))
                for f in ("target", "result_class", "type", "packages",
                          "misconf_summary", "misconfigurations",
                          "secrets", "licenses", "custom_resources",
                          "modified_findings")
                if getattr(r, f)}
        yield _frame("result", _vuln_table(r.vulnerabilities, env=meta))
    yield _frame("end")


def encode_scan_response(results: list[Result], os_found: OS) -> bytes:
    return b"".join(scan_response_frames(results, os_found))


def decode_scan_response(body: bytes) -> tuple[list[Result], OS]:
    os_found = OS()
    results: list[Result] = []
    for header, payload in frames(body):
        kind = header.get("k")
        if kind == "env":
            env = json.loads(payload)
            os_found = from_dict(OS, env.get("os") or {}) or OS()
        elif kind == "result":
            vulns, meta = _vulns_from_table(payload)
            r = from_dict(Result, meta)
            r.vulnerabilities = vulns
            results.append(r)
    return results, os_found


# --------------------------------------------------------- scan request


def encode_scan_request(target: str, artifact_key: str,
                        blob_keys: list[str],
                        options: ScanOptions) -> bytes:
    env = {"target": target, "artifact_id": artifact_key,
           "options": wire._jsonable(options)}
    arrays: dict = {}
    _put_str(arrays, "blob_ids", list(blob_keys))
    return b"".join((
        MAGIC,
        _frame("env", json.dumps(env, ensure_ascii=False).encode()),
        _frame("blob_ids", _pack_cols(arrays)),
        _frame("end"),
    ))


def decode_scan_request(
        body: bytes) -> tuple[str, str, list[str], ScanOptions]:
    env: dict = {}
    blob_ids: list[str] = []
    for header, payload in frames(body):
        kind = header.get("k")
        if kind == "env":
            env = json.loads(payload)
        elif kind == "blob_ids":
            blob_ids = _get_str(_load_cols(payload), "blob_ids")
    return (env.get("target", ""), env.get("artifact_id", ""),
            blob_ids, from_dict(ScanOptions, env.get("options") or {}))


# ---------------------------------------------------------- cache RPCs

_PKG_HOT = ("id", "name", "version")


def encode_put_blob(diff_id: str, blob_info: dict) -> bytes:
    """PutBlob with each application's package list as a columnar
    table (hot keys as string columns, the remainder per-row JSON);
    the envelope carries everything else verbatim."""
    env = dict(blob_info)
    apps = env.pop("applications", None)
    out = [MAGIC,
           _frame("env", json.dumps(
               {"diff_id": diff_id, "blob_info": env,
                "has_apps": apps is not None},
               ensure_ascii=False).encode())]
    for app in apps or []:
        meta = {k: v for k, v in app.items() if k != "packages"}
        pkgs = app.get("packages") or []
        arrays: dict = {"n": np.asarray([len(pkgs)], dtype=np.int64),
                        "has_pkgs": np.asarray(
                            ["packages" in app], dtype=np.uint8)}
        for f in _PKG_HOT:
            _put_str(arrays, f, [str(p.get(f, "")) for p in pkgs])
            arrays["has_" + f] = np.asarray(
                [f in p for p in pkgs], dtype=np.uint8)
        _put_json_col(arrays, "rest", [
            {k: v for k, v in p.items() if k not in _PKG_HOT}
            for p in pkgs])
        out.append(_frame("app", _pack_cols(arrays), env=meta))
    out.append(_frame("end"))
    return b"".join(out)


def decode_put_blob(body: bytes) -> tuple[str, dict]:
    diff_id = ""
    blob_info: dict = {}
    apps: list[dict] = []
    has_apps = False
    for header, payload in frames(body):
        kind = header.get("k")
        if kind == "env":
            env = json.loads(payload)
            diff_id = env.get("diff_id", "")
            blob_info = env.get("blob_info") or {}
            has_apps = bool(env.get("has_apps", False))
        elif kind == "app":
            app = dict(header.get("env") or {})
            z = _load_cols(payload)
            try:
                n = int(z["n"][0])
                has_pkgs = bool(z["has_pkgs"][0])
            except KeyError as exc:
                raise WireFormatError(f"missing column {exc}") from exc
            hot = {f: _get_str(z, f) for f in _PKG_HOT}
            present = {f: z["has_" + f].tolist() for f in _PKG_HOT}
            rest = _get_json_col(z, "rest")
            pkgs = []
            for i in range(n):
                p = {f: hot[f][i] for f in _PKG_HOT if present[f][i]}
                if rest[i]:
                    p.update(rest[i])
                pkgs.append(p)
            if has_pkgs:
                app["packages"] = pkgs
            apps.append(app)
    if has_apps:
        blob_info["applications"] = apps
    return diff_id, blob_info


def encode_missing_blobs(artifact_id: str, blob_ids: list[str]) -> bytes:
    arrays: dict = {}
    _put_str(arrays, "blob_ids", list(blob_ids))
    return b"".join((
        MAGIC,
        _frame("env", json.dumps({"artifact_id": artifact_id},
                                 ensure_ascii=False).encode()),
        _frame("blob_ids", _pack_cols(arrays)),
        _frame("end"),
    ))


def decode_missing_blobs(body: bytes) -> tuple[str, list[str]]:
    artifact_id = ""
    blob_ids: list[str] = []
    for header, payload in frames(body):
        kind = header.get("k")
        if kind == "env":
            artifact_id = json.loads(payload).get("artifact_id", "")
        elif kind == "blob_ids":
            blob_ids = _get_str(_load_cols(payload), "blob_ids")
    return artifact_id, blob_ids


def encode_missing_response(missing_artifact: bool,
                            missing_blob_ids: list[str]) -> bytes:
    arrays: dict = {}
    _put_str(arrays, "missing_blob_ids", list(missing_blob_ids))
    return b"".join((
        MAGIC,
        _frame("env", json.dumps(
            {"missing_artifact": bool(missing_artifact)},
            ensure_ascii=False).encode()),
        _frame("missing_blob_ids", _pack_cols(arrays)),
        _frame("end"),
    ))


def decode_missing_response(body: bytes) -> tuple[bool, list[str]]:
    missing_artifact = True
    ids: list[str] = []
    for header, payload in frames(body):
        kind = header.get("k")
        if kind == "env":
            missing_artifact = bool(
                json.loads(payload).get("missing_artifact", True))
        elif kind == "missing_blob_ids":
            ids = _get_str(_load_cols(payload), "missing_blob_ids")
    return missing_artifact, ids


# ------------------------------------------------- PkgQuery ingest seam


def encode_queries(queries: list) -> bytes:
    """PkgQuery list -> one columnar table (the thin-client match
    ingest: space/name/version/scheme columns feed
    ``detector/engine.encode_packages`` as dense arrays with no
    per-dict decode)."""
    arrays: dict = {}
    _put_str(arrays, "space", [q.space for q in queries])
    _put_str(arrays, "name", [q.name for q in queries])
    _put_str(arrays, "version", [q.version for q in queries])
    _put_str(arrays, "scheme", [q.scheme_name for q in queries])
    return b"".join((MAGIC,
                     _frame("queries", _pack_cols(arrays)),
                     _frame("end")))


def decode_queries(body: bytes) -> list:
    from trivy_tpu_torch.detector.engine import queries_from_columns

    for header, payload in frames(body):
        if header.get("k") == "queries":
            z = _load_cols(payload)
            return queries_from_columns(
                _get_str(z, "space"), _get_str(z, "name"),
                _get_str(z, "version"), _get_str(z, "scheme"))
    return []


# ------------------------------------------------------- format sniffing


def is_columnar(body: bytes) -> bool:
    return body.startswith(MAGIC)
