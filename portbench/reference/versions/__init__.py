"""Version schemes and constraint matching for the plain reference.

A frozen copy of the port's comparators (`trivy_tpu_torch/versioning`,
without bitnami), taken when the benchmark was written: the yardstick
must not move when a later change edits the program's own copy. Only
`compare`/`parse` and `Constraints.check` are used here; the token
packing the copies also carry is the program's business.
"""

from __future__ import annotations

from . import apk, deb, maven, npm, pep440, rpm, rubygems, semver
from .base import ParseError, Scheme
from .constraints import Constraints

SCHEMES: dict[str, Scheme] = {
    s.name: s for s in (apk.SCHEME, deb.SCHEME, rpm.SCHEME, semver.SCHEME,
                        npm.SCHEME, pep440.SCHEME, maven.SCHEME,
                        rubygems.SCHEME)}

__all__ = ["SCHEMES", "Constraints", "ParseError", "Scheme"]
