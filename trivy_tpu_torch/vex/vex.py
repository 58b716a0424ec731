"""VEX document parsing + report filtering (reference pkg/vex/vex.go:65
Filter; format decoders in pkg/vex/{openvex,cyclonedx,csaf}.go).

Statuses that suppress a finding: not_affected, fixed (reference
pkg/vex/vex.go NotAffected/Fixed handling). Suppressed findings move to
the result's modified-findings list rather than vanishing, mirroring
--show-suppressed.

Copy of trivy_tpu/vex/vex.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from trivy_tpu_torch.log import logger
from trivy_tpu_torch.types.report import Report, Result
from trivy_tpu_torch.utils.purl import parse_purl

_log = logger("vex")

STATUS_NOT_AFFECTED = "not_affected"
STATUS_AFFECTED = "affected"
STATUS_FIXED = "fixed"
STATUS_UNDER_INVESTIGATION = "under_investigation"

_SUPPRESS = (STATUS_NOT_AFFECTED, STATUS_FIXED)


@dataclass
class VexStatement:
    vulnerability_id: str = ""
    vuln_aliases: list[str] = field(default_factory=list)
    status: str = ""
    justification: str = ""
    impact: str = ""           # impact_statement / detail
    # purls or bom-refs; a statement with no identifiable products never
    # suppresses (reference only suppresses on a product match — a
    # products-less statement would otherwise drop the CVE for EVERY
    # package in the report)
    products: list[str] = field(default_factory=list)
    # product id -> subcomponent ids (OpenVEX: the statement applies to
    # vulnerabilities in these subcomponents of the product). A product
    # with no subcomponents applies to the product itself and everything
    # below it.
    subcomponents: dict[str, list[str]] = field(default_factory=dict)

    def _ids_match(self, vuln_id: str, aliases: list[str]) -> bool:
        return bool({vuln_id, *aliases} &
                    {self.vulnerability_id, *self.vuln_aliases})

    def matches(self, vuln_id: str, aliases: list[str], purl: str,
                bom_ref: str = "") -> bool:
        if not self._ids_match(vuln_id, aliases) or not self.products:
            return False
        return any(
            _purl_match(p, purl) or (bom_ref and p == bom_ref)
            for p in self.products
        )

    def matches_component(self, vuln_id: str, aliases: list[str],
                          node_purl: str, node_ref: str,
                          leaf_purl: str, leaf_ref: str) -> bool:
        """Reachability form (reference vex.go NotAffected(vuln, product,
        subComponent)): the statement's product must match the graph
        node, and when the statement carries subcomponents the vulnerable
        leaf must be one of them."""
        if not self._ids_match(vuln_id, aliases) or not self.products:
            return False
        for p in self.products:
            if not (_purl_match(p, node_purl)
                    or (node_ref and p == node_ref)):
                continue
            subs = self.subcomponents.get(p)
            if not subs:
                return True
            if any(_purl_match(s, leaf_purl)
                   or (leaf_ref and s == leaf_ref) for s in subs):
                return True
        return False


@dataclass
class VexDocument:
    source: str = ""
    statements: list[VexStatement] = field(default_factory=list)


def _purl_match(pattern: str, purl: str) -> bool:
    """PURL containment: pattern matches when all its set fields equal
    the target's (reference pkg/purl Match semantics)."""
    if not purl:
        return False
    if pattern == purl:
        return True
    if not pattern.startswith("pkg:"):
        return False  # bom-ref style identifier, not a purl
    try:
        a = parse_purl(pattern)
        b = parse_purl(purl)
    except Exception:
        return False
    if a.type != b.type:
        return False
    if a.namespace and a.namespace != b.namespace:
        return False
    if a.name and a.name != b.name:
        return False
    if a.version and a.version != b.version:
        return False
    for k, v in (a.qualifiers or {}).items():
        if (b.qualifiers or {}).get(k) != v:
            return False
    return True


# ------------------------------------------------------------ decoders


def _decode_openvex(doc: dict, source: str) -> VexDocument:
    out = VexDocument(source=source)
    for st in doc.get("statements") or []:
        vuln = st.get("vulnerability") or {}
        vid = vuln.get("name") or vuln.get("@id", "")
        aliases = [str(a) for a in vuln.get("aliases") or []]
        products = []
        subcomponents: dict[str, list[str]] = {}
        for p in st.get("products") or []:
            pid = p.get("@id", "") if isinstance(p, dict) else str(p)
            if pid:
                products.append(pid)
            subs = []
            for sub in (p.get("subcomponents") or []
                        if isinstance(p, dict) else []):
                sid = sub.get("@id", "") if isinstance(sub, dict) \
                    else str(sub)
                if sid:
                    subs.append(sid)
            if pid and subs:
                subcomponents[pid] = subs
        out.statements.append(VexStatement(
            vulnerability_id=vid,
            vuln_aliases=aliases,
            status=st.get("status", ""),
            justification=st.get("justification", ""),
            impact=st.get("impact_statement", ""),
            products=products,
            subcomponents=subcomponents,
        ))
    return out


_CDX_STATE = {
    "not_affected": STATUS_NOT_AFFECTED,
    "exploitable": STATUS_AFFECTED,
    "resolved": STATUS_FIXED,
    "resolved_with_pedigree": STATUS_FIXED,
    "in_triage": STATUS_UNDER_INVESTIGATION,
    "false_positive": STATUS_NOT_AFFECTED,
}


def _decode_cyclonedx(doc: dict, source: str) -> VexDocument:
    out = VexDocument(source=source)
    for v in doc.get("vulnerabilities") or []:
        analysis = v.get("analysis") or {}
        status = _CDX_STATE.get(analysis.get("state", ""), "")
        products = [
            a.get("ref", "") for a in v.get("affects") or []
            if isinstance(a, dict) and a.get("ref")
        ]
        out.statements.append(VexStatement(
            vulnerability_id=v.get("id", ""),
            status=status,
            justification=analysis.get("justification", ""),
            impact=analysis.get("detail", ""),
            products=products,
        ))
    return out


def _decode_csaf(doc: dict, source: str) -> VexDocument:
    out = VexDocument(source=source)
    purl_by_product = _csaf_product_purls(doc.get("product_tree") or {})

    def expand(ids) -> list[str]:
        purls = []
        for pid in ids or []:
            purls.extend(purl_by_product.get(pid, []))
        return purls

    for v in doc.get("vulnerabilities") or []:
        vid = v.get("cve") or (v.get("ids") or [{}])[0].get("text", "")
        ps = v.get("product_status") or {}
        just = ""
        for flag in v.get("flags") or []:
            just = flag.get("label", "") or just
        for status, key in (
            (STATUS_NOT_AFFECTED, "known_not_affected"),
            (STATUS_FIXED, "fixed"),
            (STATUS_AFFECTED, "known_affected"),
            (STATUS_UNDER_INVESTIGATION, "under_investigation"),
        ):
            ids = ps.get(key)
            if ids:
                out.statements.append(VexStatement(
                    vulnerability_id=vid, status=status,
                    justification=just, products=expand(ids),
                ))
    return out


def _csaf_product_purls(tree: dict) -> dict[str, list[str]]:
    """product_id -> purls, from product_tree branches + relationships."""
    out: dict[str, list[str]] = {}

    def walk(branch):
        if isinstance(branch, dict):
            prod = branch.get("product")
            if isinstance(prod, dict):
                pid = prod.get("product_id", "")
                helper = (prod.get("product_identification_helper")
                          or {})
                purl = helper.get("purl", "")
                if pid and purl:
                    out.setdefault(pid, []).append(purl)
            for b in branch.get("branches") or []:
                walk(b)

    for b in tree.get("branches") or []:
        walk(b)
    # relationships compose products; inherit component purls
    for rel in tree.get("relationships") or []:
        full = (rel.get("full_product_name") or {}).get("product_id", "")
        ref = rel.get("product_reference", "")
        if full and ref in out:
            out.setdefault(full, []).extend(out[ref])
    return out


def load_vex(path: str) -> VexDocument:
    """Sniff the format and decode (reference pkg/vex/document.go)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if "statements" in doc and "@context" in doc:
        return _decode_openvex(doc, path)
    if doc.get("bomFormat") == "CycloneDX":
        return _decode_cyclonedx(doc, path)
    category = (doc.get("document") or {}).get("category", "")
    if category.startswith("csaf"):
        return _decode_csaf(doc, path)
    raise ValueError(f"unrecognized VEX format in {path}")


# ------------------------------------------------------------ filtering


@dataclass
class _Node:
    """One component in the report's dependency graph."""

    purl: str = ""
    ref: str = ""
    parents: list[str] = field(default_factory=list)
    root: bool = False


def _component_graph(report: Report) -> dict[str, _Node]:
    """Report -> child-to-parents component graph (the reference builds
    the same shape through the SBOM encoder, vex.go:75-78): package
    `depends_on` edges point downward, so each dependency records its
    dependents as parents; packages nobody depends on hang off a root
    node carrying the artifact's identity (image purl when present)."""
    nodes: dict[str, _Node] = {}
    root_purl = ""
    md = getattr(report, "metadata", None)
    if md is not None and getattr(md, "repo_digests", None):
        # pkg:oci purl of the scanned image (reference purl.TypeOCI)
        dig = md.repo_digests[0]
        if "@" in dig:
            name, digest = dig.rsplit("@", 1)
            root_purl = (f"pkg:oci/{name.rsplit('/', 1)[-1]}@{digest}"
                         f"?repository_url={name}")
    nodes["__root__"] = _Node(purl=root_purl, ref=report.artifact_name,
                              root=True)
    for res in report.results:
        key_of: dict[str, str] = {}
        for p in res.packages:
            uid = p.identifier.uid or p.identifier.purl or \
                f"{res.target}:{p.id}"
            key_of[p.id] = uid
            nodes.setdefault(uid, _Node(
                purl=p.identifier.purl,
                ref=p.identifier.bom_ref or ""))
        has_parent: set[str] = set()
        for p in res.packages:
            uid = key_of[p.id]
            for dep in p.depends_on:
                child = key_of.get(dep)
                if child is not None:
                    nodes[child].parents.append(uid)
                    has_parent.add(child)
        for p in res.packages:
            uid = key_of[p.id]
            if uid not in has_parent and \
                    "__root__" not in nodes[uid].parents:
                nodes[uid].parents.append("__root__")
    return nodes


def filter_report_vex(report: Report, vex_sources: list) -> int:
    """Suppress findings asserted not_affected/fixed; returns the number
    suppressed. Suppressed entries are kept on the result as modified
    findings (rendered under ExperimentalModifiedFindings).

    Suppression is reachability-aware (reference vex.go reachRoot): a
    statement may target an ANCESTOR product (e.g. the container image or
    an aggregate package) with the vulnerable package as subcomponent,
    and a finding is only suppressed when every dependency path from the
    vulnerable component to the root is covered by a statement."""
    graph = _component_graph(report)
    total = 0
    for res in report.results:
        total += _filter_result(res, vex_sources, graph)
    return total


def _candidates(src, vuln, purl: str) -> list[tuple[str, VexStatement]]:
    """Statements of one source possibly relevant to (vuln, component)."""
    if hasattr(src, "candidate_statements"):
        return src.candidate_statements(purl)
    return [(src.source, st) for st in src.statements]


def _filter_result(res: Result, vex_sources: list,
                   graph: dict[str, _Node]) -> int:
    kept = []
    modified = getattr(res, "modified_findings", None) or []
    for v in res.vulnerabilities:
        leaf_purl = v.pkg_identifier.purl
        leaf_ref = v.pkg_identifier.bom_ref
        leaf_uid = v.pkg_identifier.uid or leaf_purl

        hit: list = []  # last matching (source, statement)

        def blocked(node: _Node) -> bool:
            for src in vex_sources:
                for source, st in _candidates(src, v, node.purl):
                    if st.status in _SUPPRESS and st.matches_component(
                        v.vulnerability_id, v.vendor_ids,
                        node.purl, node.ref, leaf_purl, leaf_ref,
                    ):
                        hit[:] = [source, st]
                        return True
            return False

        leaf = graph.get(leaf_uid) or _Node(purl=leaf_purl, ref=leaf_ref)

        def reaches_root(uid: str, node: _Node, seen: set) -> bool:
            if blocked(node):
                return False
            if node.root or not node.parents:
                return True
            seen.add(uid)
            for parent in node.parents:
                if parent in seen:
                    continue
                pn = graph.get(parent)
                if pn is None or reaches_root(parent, pn, seen):
                    return True
            return False

        if reaches_root(leaf_uid, leaf, set()) or not hit:
            # no path reached the root AND nothing was blocked: a
            # dependency cycle with no matching statement — keep the
            # finding (suppression requires an actual statement)
            kept.append(v)
            continue
        source, st = hit
        modified.append({
            "Type": "vulnerability",
            "Status": st.status,
            "Statement": st.justification or st.impact or "",
            "Source": source,
            "Finding": v.to_dict(),
        })
        _log.debug("vex suppressed", id=v.vulnerability_id,
                   status=st.status, source=source)
    suppressed = len(res.vulnerabilities) - len(kept)
    res.vulnerabilities = kept
    res.modified_findings = modified
    return suppressed
