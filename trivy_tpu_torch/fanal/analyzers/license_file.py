"""Loose license-file analyzer (reference
pkg/fanal/analyzer/licensing/license.go): classify LICENSE/COPYING/
NOTICE-style files, and — in license-full mode — headers of ordinary
source files, into LicenseFile findings.

Copy of trivy_tpu/fanal/analyzers/license_file.py, whole, with its imports rewritten.
"""

from __future__ import annotations

import os

from trivy_tpu_torch.fanal.analyzer import AnalysisInput, AnalysisResult, Analyzer, register
from trivy_tpu_torch.licensing import classifier

_LICENSE_NAMES = {
    "license", "licence", "copying", "copyright", "eula", "notice",
    "patents", "unlicense", "unlicence",
}
_TEXT_EXTS = {"", ".txt", ".md", ".rst", ".html"}

# license-full mode additionally scans source files for license headers
_SOURCE_EXTS = {
    ".c", ".cc", ".cpp", ".h", ".hpp", ".go", ".py", ".js", ".ts", ".java",
    ".rb", ".rs", ".php", ".cs", ".swift", ".kt", ".scala", ".sh",
}

_MAX_SIZE = 1 << 20  # classify only reasonably sized text files


@register
class LicenseFileAnalyzer(Analyzer):
    type = "license-file"
    version = 1

    # class attrs toggled per scan by cli.run._select_scanner when
    # --license-full is set (same pattern as secret_analyzer.USE_DEVICE)
    full = False
    confidence_level = 0.75

    def required(self, path: str, size: int = 0, mode: int = 0) -> bool:
        if size > _MAX_SIZE:
            return False
        base = os.path.basename(path).lower()
        stem, ext = os.path.splitext(base)
        if ext in _TEXT_EXTS and (stem in _LICENSE_NAMES
                                  or base in _LICENSE_NAMES):
            return True
        # e.g. LICENSE-MIT.txt, LICENSE.Apache-2.0 — but not source files
        # like license-checker.py (tooling, not license text)
        if ext not in _SOURCE_EXTS and \
                any(stem.startswith(n + "-") or stem.startswith(n + ".")
                    for n in ("license", "licence", "copying")):
            return True
        if self.full and ext in _SOURCE_EXTS:
            return True
        return False

    def analyze(self, inp: AnalysisInput):
        content = inp.read()
        if b"\x00" in content[:512]:  # binary
            return None
        lf = classifier.classify(inp.path, content, self.confidence_level)
        if lf is None:
            return None
        res = AnalysisResult()
        res.licenses = [lf]
        return res
