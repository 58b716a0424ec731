"""Twirp wire compatibility: `trivy.scanner.v1.Scanner` and
`trivy.cache.v1.Cache` over protobuf-or-JSON HTTP, the reference's RPC
protocol (reference rpc/scanner/service.proto, rpc/cache/service.proto,
pkg/rpc/convert.go; Twirp spec v7).

A reference trivy client POSTs
  /twirp/trivy.scanner.v1.Scanner/Scan        (Content-Type
  /twirp/trivy.cache.v1.Cache/PutBlob          application/protobuf or
  ...                                          application/json)
and this module decodes/encodes those bodies against hand-written schema
tables of the reference .proto field numbers: a generic proto3 codec
(varint/length-delimited wire format, maps as repeated k/v messages,
packed-or-not repeated scalars on decode) plus the proto3 JSON mapping
(lowerCamel names, enum value names, RFC3339 timestamps). No generated
code and no protobuf runtime — the schema tables ARE the compat surface.

Errors use the Twirp JSON envelope {"code": ..., "msg": ...}.

Copy of trivy_tpu/rpc/twirp.py.
"""

from __future__ import annotations

import datetime
import json
import re
import struct

# --------------------------------------------------------------- schema
#
# field spec: (name, kind, repeated)
#   kinds: "string" | "bytes" | "int32" | "int64" | "bool" | "double"
#        | "float" | "enum" | "msg:<Name>" | "map:<kkind>:<vkind>"

S = "string"
I32, I64, B, D, F, E = "int32", "int64", "bool", "double", "float", "enum"


def _m(name):
    return f"msg:{name}"


SCHEMAS: dict[str, dict[int, tuple]] = {
    "Timestamp": {1: ("seconds", I64, False), 2: ("nanos", I32, False)},
    "Empty": {},
    "OS": {1: ("family", S, False), 2: ("name", S, False),
           3: ("eosl", B, False), 4: ("extended", B, False)},
    "Repository": {1: ("family", S, False), 2: ("release", S, False)},
    "PkgIdentifier": {1: ("purl", S, False), 2: ("bom_ref", S, False),
                      3: ("uid", S, False)},
    "Location": {1: ("start_line", I32, False), 2: ("end_line", I32, False)},
    "Layer": {1: ("digest", S, False), 2: ("diff_id", S, False),
              3: ("created_by", S, False)},
    "Package": {
        13: ("id", S, False), 1: ("name", S, False),
        2: ("version", S, False), 3: ("release", S, False),
        4: ("epoch", I32, False), 19: ("identifier", _m("PkgIdentifier"), False),
        5: ("arch", S, False), 6: ("src_name", S, False),
        7: ("src_version", S, False), 8: ("src_release", S, False),
        9: ("src_epoch", I32, False), 15: ("licenses", S, True),
        20: ("locations", _m("Location"), True),
        11: ("layer", _m("Layer"), False), 12: ("file_path", S, False),
        14: ("depends_on", S, True), 16: ("digest", S, False),
        17: ("dev", B, False), 18: ("indirect", B, False),
        21: ("maintainer", S, False),
    },
    "PackageInfo": {1: ("file_path", S, False),
                    2: ("packages", _m("Package"), True)},
    "Application": {1: ("type", S, False), 2: ("file_path", S, False),
                    3: ("packages", _m("Package"), True)},
    "DataSource": {1: ("id", S, False), 2: ("name", S, False),
                   3: ("url", S, False)},
    "CVSS": {1: ("v2_vector", S, False), 2: ("v3_vector", S, False),
             3: ("v2_score", D, False), 4: ("v3_score", D, False),
             5: ("v40_vector", S, False), 6: ("v40_score", D, False)},
    "Vulnerability": {
        1: ("vulnerability_id", S, False), 2: ("pkg_name", S, False),
        3: ("installed_version", S, False), 4: ("fixed_version", S, False),
        5: ("title", S, False), 6: ("description", S, False),
        7: ("severity", E, False), 8: ("references", S, True),
        25: ("pkg_identifier", _m("PkgIdentifier"), False),
        10: ("layer", _m("Layer"), False),
        11: ("severity_source", S, False),
        12: ("cvss", f"map:{S}:msg:CVSS", False),
        13: ("cwe_ids", S, True), 14: ("primary_url", S, False),
        15: ("published_date", _m("Timestamp"), False),
        16: ("last_modified_date", _m("Timestamp"), False),
        19: ("vendor_ids", S, True),
        20: ("data_source", _m("DataSource"), False),
        21: ("vendor_severity", f"map:{S}:{E}", False),
        22: ("pkg_path", S, False), 23: ("pkg_id", S, False),
        24: ("status", I32, False),
    },
    "Line": {1: ("number", I32, False), 2: ("content", S, False),
             3: ("is_cause", B, False), 4: ("annotation", S, False),
             5: ("truncated", B, False), 6: ("highlighted", S, False),
             7: ("first_cause", B, False), 8: ("last_cause", B, False)},
    "Code": {1: ("lines", _m("Line"), True)},
    "CauseMetadata": {
        1: ("resource", S, False), 2: ("provider", S, False),
        3: ("service", S, False), 4: ("start_line", I32, False),
        5: ("end_line", I32, False), 6: ("code", _m("Code"), False)},
    "DetectedMisconfiguration": {
        1: ("type", S, False), 2: ("id", S, False), 3: ("title", S, False),
        4: ("description", S, False), 5: ("message", S, False),
        6: ("namespace", S, False), 7: ("resolution", S, False),
        8: ("severity", E, False), 9: ("primary_url", S, False),
        10: ("references", S, True), 11: ("status", S, False),
        12: ("layer", _m("Layer"), False),
        13: ("cause_metadata", _m("CauseMetadata"), False),
        14: ("avd_id", S, False), 15: ("query", S, False)},
    "PolicyMetadata": {
        1: ("id", S, False), 2: ("adv_id", S, False), 3: ("type", S, False),
        4: ("title", S, False), 5: ("description", S, False),
        6: ("severity", S, False), 7: ("recommended_actions", S, False),
        8: ("references", S, True)},
    "MisconfResult": {
        1: ("namespace", S, False), 2: ("message", S, False),
        7: ("policy_metadata", _m("PolicyMetadata"), False),
        8: ("cause_metadata", _m("CauseMetadata"), False)},
    "Misconfiguration": {
        1: ("file_type", S, False), 2: ("file_path", S, False),
        3: ("successes", _m("MisconfResult"), True),
        4: ("warnings", _m("MisconfResult"), True),
        5: ("failures", _m("MisconfResult"), True)},
    "SecretFinding": {
        1: ("rule_id", S, False), 2: ("category", S, False),
        3: ("severity", S, False), 4: ("title", S, False),
        5: ("start_line", I32, False), 6: ("end_line", I32, False),
        7: ("code", _m("Code"), False), 8: ("match", S, False),
        10: ("layer", _m("Layer"), False)},
    "Secret": {1: ("filepath", S, False),
               2: ("findings", _m("SecretFinding"), True)},
    "LicenseFinding": {
        1: ("category", E, False), 2: ("name", S, False),
        3: ("confidence", F, False), 4: ("link", S, False)},
    "LicenseFile": {
        1: ("license_type", E, False), 2: ("file_path", S, False),
        3: ("pkg_name", S, False),
        4: ("fingings", _m("LicenseFinding"), True),  # sic, per .proto
        5: ("layer", _m("Layer"), False)},
    "DetectedLicense": {
        1: ("severity", E, False), 2: ("category", E, False),
        3: ("pkg_name", S, False), 4: ("file_path", S, False),
        5: ("name", S, False), 6: ("confidence", F, False),
        7: ("link", S, False), 8: ("text", S, False)},
    "CustomResource": {
        1: ("type", S, False), 2: ("file_path", S, False),
        3: ("layer", _m("Layer"), False)},
    # scanner service
    "Licenses": {1: ("names", S, True)},
    "ScanOptions": {
        1: ("pkg_types", S, True), 2: ("scanners", S, True),
        4: ("license_categories", "map:string:msg:Licenses", False),
        5: ("include_dev_deps", B, False),
        6: ("pkg_relationships", S, True),
        7: ("distro", _m("OS"), False)},
    "ScanRequest": {
        1: ("target", S, False), 2: ("artifact_id", S, False),
        3: ("blob_ids", S, True),
        4: ("options", _m("ScanOptions"), False)},
    "Result": {
        1: ("target", S, False),
        2: ("vulnerabilities", _m("Vulnerability"), True),
        4: ("misconfigurations", _m("DetectedMisconfiguration"), True),
        6: ("class", S, False), 3: ("type", S, False),
        5: ("packages", _m("Package"), True),
        7: ("custom_resources", _m("CustomResource"), True),
        8: ("secrets", _m("SecretFinding"), True),
        9: ("licenses", _m("DetectedLicense"), True)},
    "ScanResponse": {1: ("os", _m("OS"), False),
                     3: ("results", _m("Result"), True)},
    # cache service
    "ArtifactInfo": {
        1: ("schema_version", I32, False), 2: ("architecture", S, False),
        3: ("created", _m("Timestamp"), False),
        4: ("docker_version", S, False), 5: ("os", S, False),
        6: ("history_packages", _m("Package"), True)},
    "PutArtifactRequest": {
        1: ("artifact_id", S, False),
        2: ("artifact_info", _m("ArtifactInfo"), False)},
    "BlobInfo": {
        1: ("schema_version", I32, False), 2: ("os", _m("OS"), False),
        11: ("repository", _m("Repository"), False),
        3: ("package_infos", _m("PackageInfo"), True),
        4: ("applications", _m("Application"), True),
        9: ("misconfigurations", _m("Misconfiguration"), True),
        5: ("opaque_dirs", S, True), 6: ("whiteout_files", S, True),
        7: ("digest", S, False), 8: ("diff_id", S, False),
        10: ("custom_resources", _m("CustomResource"), True),
        12: ("secrets", _m("Secret"), True),
        13: ("licenses", _m("LicenseFile"), True)},
    "PutBlobRequest": {1: ("diff_id", S, False),
                       3: ("blob_info", _m("BlobInfo"), False)},
    "MissingBlobsRequest": {1: ("artifact_id", S, False),
                            2: ("blob_ids", S, True)},
    "MissingBlobsResponse": {1: ("missing_artifact", B, False),
                             2: ("missing_blob_ids", S, True)},
    "DeleteBlobsRequest": {1: ("blob_ids", S, True)},
}

_VARINT_KINDS = {I32, I64, B, E}


# --------------------------------------------------------- wire codec


def _enc_varint(n: int) -> bytes:
    if n < 0:
        n &= (1 << 64) - 1  # negative int32/64 encode as 10-byte varint
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _enc_field(num: int, kind: str, value) -> bytes:
    if kind in _VARINT_KINDS:
        v = int(value) if not isinstance(value, bool) else int(value)
        if kind in (I32, I64) and v < 0:
            v &= (1 << 64) - 1
        return _enc_varint(num << 3) + _enc_varint(v)
    if kind == D:
        return _enc_varint((num << 3) | 1) + struct.pack("<d", float(value))
    if kind == F:
        return _enc_varint((num << 3) | 5) + struct.pack("<f", float(value))
    if kind in (S, "bytes"):
        raw = value.encode() if isinstance(value, str) else bytes(value)
        return _enc_varint((num << 3) | 2) + _enc_varint(len(raw)) + raw
    if kind.startswith("msg:"):
        raw = encode_message(kind[4:], value)
        return _enc_varint((num << 3) | 2) + _enc_varint(len(raw)) + raw
    raise ValueError(f"unknown kind {kind}")


def _map_kinds(kind: str) -> tuple[str, str]:
    _, kk, *rest = kind.split(":")
    return kk, ":".join(rest)


def encode_message(name: str, doc: dict) -> bytes:
    """Python dict (snake_case field names) -> proto3 wire bytes."""
    schema = SCHEMAS[name]
    out = bytearray()
    for num in sorted(schema):
        fname, kind, repeated = schema[num]
        v = doc.get(fname)
        if v is None:
            continue
        if kind.startswith("map:"):
            kk, vk = _map_kinds(kind)
            for k in v:
                entry = _enc_field(1, kk, k) + _enc_field(2, vk, v[k])
                out += _enc_varint((num << 3) | 2)
                out += _enc_varint(len(entry)) + entry
            continue
        if repeated:
            for item in v:
                out += _enc_field(num, kind, item)
            continue
        # proto3 zero values are omitted
        if v in ("", 0, False, 0.0) and not kind.startswith("msg:"):
            continue
        out += _enc_field(num, kind, v)
    return bytes(out)


def _dec_value(kind: str, wire_type: int, buf: bytes, pos: int):
    if wire_type == 0:
        val, pos = _dec_varint(buf, pos)
        if kind == B:
            val = bool(val)
        elif kind == I32 and val >= 1 << 31:
            val -= 1 << 32 if val < 1 << 32 else 1 << 64
        return val, pos
    if wire_type == 1:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if wire_type == 5:
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if wire_type == 2:
        ln, pos = _dec_varint(buf, pos)
        raw = buf[pos:pos + ln]
        pos += ln
        if kind in (S,):
            return raw.decode("utf-8", "replace"), pos
        if kind == "bytes":
            return raw, pos
        if kind.startswith("msg:"):
            return decode_message(kind[4:], raw), pos
        # packed repeated scalars
        vals = []
        p2 = 0
        while p2 < len(raw):
            v, p2 = _dec_varint(raw, p2)
            if kind == B:
                v = bool(v)
            vals.append(v)
        return vals, pos
    raise ValueError(f"wire type {wire_type}")


def decode_message(name: str, buf: bytes) -> dict:
    """proto3 wire bytes -> Python dict (snake_case names; zero values
    absent, repeated as lists, maps as dicts)."""
    schema = SCHEMAS[name]
    out: dict = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _dec_varint(buf, pos)
        num, wt = tag >> 3, tag & 7
        spec = schema.get(num)
        if spec is None:  # unknown field: skip
            if wt == 0:
                _, pos = _dec_varint(buf, pos)
            elif wt == 1:
                pos += 8
            elif wt == 5:
                pos += 4
            elif wt == 2:
                ln, pos = _dec_varint(buf, pos)
                pos += ln
            else:
                raise ValueError(f"cannot skip wire type {wt}")
            continue
        fname, kind, repeated = spec
        if kind.startswith("map:"):
            kk, vk = _map_kinds(kind)
            ln, pos = _dec_varint(buf, pos)
            entry = buf[pos:pos + ln]
            pos += ln
            k = "" if kk == S else 0
            v: object = None
            p2 = 0
            while p2 < len(entry):
                t2, p2 = _dec_varint(entry, p2)
                if t2 >> 3 == 1:
                    k, p2 = _dec_value(kk, t2 & 7, entry, p2)
                else:
                    v, p2 = _dec_value(vk, t2 & 7, entry, p2)
            if v is None:
                v = decode_message(vk[4:], b"") if vk.startswith("msg:") \
                    else (0 if vk in _VARINT_KINDS else "")
            out.setdefault(fname, {})[k] = v
            continue
        val, pos = _dec_value(kind, wt, buf, pos)
        if repeated:
            tgt = out.setdefault(fname, [])
            if isinstance(val, list):
                tgt.extend(val)
            else:
                tgt.append(val)
        else:
            out[fname] = val
    return out


# ----------------------------------------------------------- JSON form


def _camel(sn: str) -> str:
    return re.sub(r"_([a-z0-9])", lambda m: m.group(1).upper(), sn)


_SEVERITY_NAMES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]


def _ts_json(doc: dict) -> str:
    secs = doc.get("seconds", 0)
    nanos = doc.get("nanos", 0)
    dt = datetime.datetime.fromtimestamp(secs, datetime.timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    if nanos:
        base += f".{nanos:09d}".rstrip("0")
    return base + "Z"


def _ts_parse(s: str) -> dict:
    m = re.match(r"(.*?)(\.\d+)?(Z|[+-]\d\d:\d\d)$", s)
    frac = 0
    if m and m.group(2):
        frac = int(float(m.group(2)) * 1e9)
        s = m.group(1) + m.group(3)
    dt = datetime.datetime.fromisoformat(s.replace("Z", "+00:00"))
    return {"seconds": int(dt.timestamp()), "nanos": frac}


def to_json_obj(name: str, doc: dict):
    """snake-named dict -> proto3 JSON object (lowerCamel, enum names,
    RFC3339 timestamps)."""
    if name == "Timestamp":
        return _ts_json(doc)
    schema = SCHEMAS[name]
    out = {}
    for num in sorted(schema):
        fname, kind, repeated = schema[num]
        if fname not in doc or doc[fname] is None:
            continue
        v = doc[fname]
        key = _camel(fname)
        if kind.startswith("map:"):
            _kk, vk = _map_kinds(kind)
            out[key] = {
                k: to_json_obj(vk[4:], x) if vk.startswith("msg:")
                else (_SEVERITY_NAMES[x] if vk == E and 0 <= x < 5 else x)
                for k, x in v.items()}
            continue
        def conv(x):
            if kind.startswith("msg:"):
                return to_json_obj(kind[4:], x)
            if kind == E:
                return _SEVERITY_NAMES[x] if 0 <= x < len(_SEVERITY_NAMES) \
                    else x
            return x
        out[key] = [conv(x) for x in v] if repeated else conv(v)
    return out


def from_json_obj(name: str, obj) -> dict:
    """proto3 JSON object -> snake-named dict (accepts lowerCamel OR
    original snake names, enum names or numbers)."""
    if name == "Timestamp":
        return _ts_parse(obj) if isinstance(obj, str) else (obj or {})
    schema = SCHEMAS[name]
    by_name = {}
    for num, (fname, kind, repeated) in schema.items():
        by_name[fname] = (fname, kind, repeated)
        by_name[_camel(fname)] = (fname, kind, repeated)
    out: dict = {}
    for key, v in (obj or {}).items():
        spec = by_name.get(key)
        if spec is None or v is None:
            continue
        fname, kind, repeated = spec
        if kind.startswith("map:"):
            _kk, vk = _map_kinds(kind)
            out[fname] = {
                k: from_json_obj(vk[4:], x) if vk.startswith("msg:")
                else (_SEVERITY_NAMES.index(x)
                      if vk == E and isinstance(x, str)
                      and x in _SEVERITY_NAMES else x)
                for k, x in v.items()}
            continue
        def conv(x):
            if kind.startswith("msg:"):
                return from_json_obj(kind[4:], x)
            if kind == E and isinstance(x, str):
                return _SEVERITY_NAMES.index(x) \
                    if x in _SEVERITY_NAMES else 0
            return x
        out[fname] = [conv(x) for x in v] if repeated else conv(v)
    return out


# ------------------------------------------------- model conversions
# (the pkg/rpc/convert.go equivalents between this framework's report
# model and the proto dicts)


def _layer_proto(layer) -> dict:
    if layer is None:
        return {}
    return {"digest": layer.digest, "diff_id": layer.diff_id,
            "created_by": getattr(layer, "created_by", "")}


def vuln_to_proto(v) -> dict:
    info = v.info
    out = {
        "vulnerability_id": v.vulnerability_id,
        "pkg_name": v.pkg_name,
        "installed_version": v.installed_version,
        "fixed_version": v.fixed_version,
        "pkg_id": v.pkg_id,
        "pkg_path": getattr(v, "pkg_path", ""),
        "status": int(v.status),
        "severity_source": v.severity_source,
        "primary_url": v.primary_url,
        "vendor_ids": list(v.vendor_ids),
        "layer": _layer_proto(v.layer),
    }
    if v.pkg_identifier is not None:
        out["pkg_identifier"] = {
            "purl": v.pkg_identifier.purl,
            "bom_ref": getattr(v.pkg_identifier, "bom_ref", ""),
            "uid": v.pkg_identifier.uid,
        }
    if v.data_source is not None:
        out["data_source"] = {"id": v.data_source.id,
                              "name": v.data_source.name,
                              "url": v.data_source.url}
    if info is not None:
        from trivy_tpu_torch.types.enums import Severity

        out.update({
            "title": info.title, "description": info.description,
            "severity": int(Severity.parse(info.severity)),
            "references": list(info.references),
            "cwe_ids": list(info.cwe_ids),
            "vendor_severity": dict(info.vendor_severity),
            "cvss": {
                src: {
                    "v2_vector": c.get("V2Vector", ""),
                    "v3_vector": c.get("V3Vector", ""),
                    "v2_score": c.get("V2Score", 0.0),
                    "v3_score": c.get("V3Score", 0.0),
                    "v40_vector": c.get("V40Vector", ""),
                    "v40_score": c.get("V40Score", 0.0),
                } for src, c in info.cvss.items()
            },
        })
        if info.published_date:
            out["published_date"] = _ts_parse(info.published_date)
        if info.last_modified_date:
            out["last_modified_date"] = _ts_parse(info.last_modified_date)
    return out


_LICENSE_CATEGORIES = ["unspecified", "forbidden", "restricted",
                       "reciprocal", "notice", "permissive",
                       "unencumbered", "unknown"]


def _code_proto(code) -> dict:
    return {"lines": [{
        "number": ln.number, "content": ln.content,
        "is_cause": ln.is_cause, "annotation": ln.annotation,
        "truncated": ln.truncated, "highlighted": ln.highlighted,
        "first_cause": ln.first_cause, "last_cause": ln.last_cause,
    } for ln in code.lines]}


def misconf_to_proto(m) -> dict:
    from trivy_tpu_torch.types.enums import Severity

    cm = m.cause_metadata
    return {
        "type": m.type, "id": m.id, "avd_id": m.avd_id, "title": m.title,
        "description": m.description, "message": m.message,
        "namespace": m.namespace, "query": m.query,
        "resolution": m.resolution,
        "severity": int(Severity.parse(m.severity)),
        "primary_url": m.primary_url, "references": list(m.references),
        "status": m.status, "layer": _layer_proto(m.layer),
        "cause_metadata": {
            "resource": cm.resource, "provider": cm.provider,
            "service": cm.service, "start_line": cm.start_line,
            "end_line": cm.end_line, "code": _code_proto(cm.code),
        },
    }


def package_to_proto(p) -> dict:
    out = {
        "id": p.id, "name": p.name, "version": p.version,
        "release": p.release, "epoch": p.epoch, "arch": p.arch,
        "src_name": p.src_name, "src_version": p.src_version,
        "src_release": p.src_release, "src_epoch": p.src_epoch,
        "licenses": list(p.licenses), "file_path": p.file_path,
        "depends_on": list(p.depends_on), "digest": p.digest,
        "dev": p.dev, "indirect": p.indirect, "maintainer": p.maintainer,
        "layer": _layer_proto(p.layer),
        "locations": [{"start_line": lo.start_line, "end_line": lo.end_line}
                      for lo in p.locations],
    }
    if p.identifier is not None:
        out["identifier"] = {
            "purl": p.identifier.purl,
            "bom_ref": getattr(p.identifier, "bom_ref", ""),
            "uid": p.identifier.uid,
        }
    return out


def license_to_proto(lic) -> dict:
    from trivy_tpu_torch.types.enums import Severity

    cat = str(lic.category).lower()
    return {
        "severity": int(Severity.parse(lic.severity)),
        "category": _LICENSE_CATEGORIES.index(cat)
        if cat in _LICENSE_CATEGORIES else 0,
        "pkg_name": lic.pkg_name, "file_path": lic.file_path,
        "name": lic.name, "confidence": lic.confidence,
        "link": lic.link, "text": lic.text,
    }


def result_to_proto(r) -> dict:
    import enum as _enum

    cls = r.result_class
    out = {
        "target": r.target,
        "class": cls.value if isinstance(cls, _enum.Enum) else str(cls),
        "type": r.type,
        "vulnerabilities": [vuln_to_proto(v) for v in r.vulnerabilities],
        "misconfigurations": [misconf_to_proto(m)
                              for m in r.misconfigurations],
        "packages": [package_to_proto(p) for p in r.packages],
        "licenses": [license_to_proto(x) for x in r.licenses],
        "secrets": [{
            "rule_id": s.rule_id, "category": s.category,
            "severity": s.severity, "title": s.title,
            "start_line": s.start_line, "end_line": s.end_line,
            "match": s.match,
        } for s in getattr(r, "secrets", [])],
    }
    return out


def os_to_proto(os_found) -> dict:
    return {"family": os_found.family, "name": os_found.name,
            "eosl": bool(getattr(os_found, "eosl", False)),
            "extended": bool(getattr(os_found, "extended", False))}


def scan_response_proto(results, os_found) -> dict:
    return {"os": os_to_proto(os_found),
            "results": [result_to_proto(r) for r in results]}


def proto_to_scan_options(doc: dict):
    from trivy_tpu_torch.types.scan import ScanOptions

    opts = ScanOptions(include_dev_deps=bool(doc.get("include_dev_deps")))
    # absent repeated fields keep the defaults (a reference client always
    # sends them; hand-rolled requests may not)
    if doc.get("pkg_types"):
        opts.pkg_types = list(doc["pkg_types"])
    if doc.get("scanners"):
        opts.scanners = list(doc["scanners"])
    if doc.get("pkg_relationships"):
        opts.pkg_relationships = list(doc["pkg_relationships"])
    return opts


# -------------------------------------------------------------- routes

SCANNER_PREFIX = "/twirp/trivy.scanner.v1.Scanner/"
CACHE_PREFIX = "/twirp/trivy.cache.v1.Cache/"

PROTO_CT = "application/protobuf"
JSON_CT = "application/json"


def _twirp_error(code: str, msg: str, http: int) -> tuple[int, str, bytes]:
    return http, JSON_CT, json.dumps({"code": code, "msg": msg}).encode()


def _decode_body(msg_name: str, ctype: str, body: bytes) -> dict:
    if ctype.startswith(PROTO_CT):
        return decode_message(msg_name, body)
    return from_json_obj(msg_name, json.loads(body or b"{}"))


def _encode_body(msg_name: str, ctype: str, doc: dict) -> tuple[str, bytes]:
    if ctype.startswith(PROTO_CT):
        return PROTO_CT, encode_message(msg_name, doc)
    return JSON_CT, json.dumps(to_json_obj(msg_name, doc)).encode()


def handle(service, path: str, ctype: str, body: bytes):
    """Dispatch a Twirp request against the rpc ScanService.
    -> (http status, content type, body) or None if not a twirp path."""
    if path.startswith(SCANNER_PREFIX):
        method = path[len(SCANNER_PREFIX):]
        if method != "Scan":
            return _twirp_error("bad_route", f"no method {method}", 404)
        try:
            req = _decode_body("ScanRequest", ctype, body)
            options = proto_to_scan_options(req.get("options") or {})
            results, os_found = service.scan(
                req.get("target", ""), req.get("artifact_id", ""),
                req.get("blob_ids") or [], options)
            ct, out = _encode_body(
                "ScanResponse", ctype,
                scan_response_proto(results, os_found))
            return 200, ct, out
        except Exception as exc:
            from trivy_tpu_torch.resilience.retry import DeadlineExceeded
            from trivy_tpu_torch.sched.scheduler import Overloaded

            if isinstance(exc, (Overloaded, DeadlineExceeded)):
                # backpressure, not an internal fault: propagate so the
                # HTTP handler sheds with 503 + Retry-After and a
                # reference client backs off instead of hammering
                raise
            return _twirp_error("internal", str(exc), 500)
    if path.startswith(CACHE_PREFIX):
        method = path[len(CACHE_PREFIX):]
        try:
            if method == "PutArtifact":
                req = _decode_body("PutArtifactRequest", ctype, body)
                service.cache.put_artifact(
                    req.get("artifact_id", ""),
                    req.get("artifact_info") or {})
            elif method == "PutBlob":
                req = _decode_body("PutBlobRequest", ctype, body)
                service.cache.put_blob(
                    req.get("diff_id", ""), req.get("blob_info") or {})
            elif method == "MissingBlobs":
                req = _decode_body("MissingBlobsRequest", ctype, body)
                ma, mb = service.cache.missing_blobs(
                    req.get("artifact_id", ""), req.get("blob_ids") or [])
                ct, out = _encode_body(
                    "MissingBlobsResponse", ctype,
                    {"missing_artifact": ma, "missing_blob_ids": mb})
                return 200, ct, out
            elif method == "DeleteBlobs":
                req = _decode_body("DeleteBlobsRequest", ctype, body)
                service.cache.delete_blobs(req.get("blob_ids") or [])
            else:
                return _twirp_error("bad_route", f"no method {method}", 404)
            ct, out = _encode_body("Empty", ctype, {})
            return 200, ct, out
        except Exception as exc:
            return _twirp_error("internal", str(exc), 500)
    return None
