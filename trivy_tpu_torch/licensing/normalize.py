"""Free-form license-name normalization to SPDX ids.

Behavioral parity with reference pkg/licensing/normalize.go: a
standardize pass (uppercase, LICENCE→LICENSE, strip THE/LICENSE
affixes, fold version suffixes like "VERSION 2.0"/"V2" to "-2.0",
extract +/-or-later/-only), then a lookup in a declared-name mapping
table (normalize.go:14-569; data originally from the OSS Review
Toolkit's license mapping).  SplitLicenses / LaxSplitLicenses mirror
normalize.go:585-767 for comma/or/and-separated declared strings.

Copy of trivy_tpu/licensing/normalize.py, whole, with its imports rewritten.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.licensing.expression import (
    CompoundExpr,
    SimpleExpr,
    normalize_expression,
    parse,
)

LICENSE_TEXT_PREFIX = "text://"
LICENSE_FILE_PREFIX = "file://"
CUSTOM_LICENSE_PREFIX = "CUSTOM License"


def _plus(spdx: str) -> tuple[str, bool]:
    return (spdx, True)


def _ident(spdx: str) -> tuple[str, bool]:
    return (spdx, False)


# Standardized (upper-cased, affix-stripped) name → (SPDX id, has_plus).
# Same fact table as reference normalize.go:14-569.
_MAPPING: dict[str, tuple[str, bool]] = {
    # ambiguous short names
    "AFL": _ident("AFL-3.0"),
    "AGPL": _ident("AGPL-3.0"),
    "APACHE": _ident("Apache-2.0"),
    "APACHE-STYLE": _ident("Apache-2.0"),
    "ARTISTIC": _ident("Artistic-2.0"),
    "ASL": _ident("Apache-2.0"),
    "BSD": _ident("BSD-3-Clause"),
    "BSD*": _ident("BSD-3-Clause"),
    "BSD-LIKE": _ident("BSD-3-Clause"),
    "BSD-STYLE": _ident("BSD-3-Clause"),
    "BSD-VARIANT": _ident("BSD-3-Clause"),
    "CDDL": _ident("CDDL-1.0"),
    "ECLIPSE": _ident("EPL-1.0"),
    "EPL": _ident("EPL-1.0"),
    "EUPL": _ident("EUPL-1.0"),
    "FDL": _plus("GFDL-1.3"),
    "GFDL": _plus("GFDL-1.3"),
    "GPL": _plus("GPL-2.0"),
    "LGPL": _plus("LGPL-2.0"),
    "MPL": _ident("MPL-2.0"),
    "NETSCAPE": _ident("NPL-1.1"),
    "PYTHON": _ident("Python-2.0"),
    "ZOPE": _ident("ZPL-2.1"),
    # versioned aliases
    "0BSD": _ident("0BSD"),
    "AFL-1.1": _ident("AFL-1.1"),
    "AFL-1.2": _ident("AFL-1.2"),
    "AFL-2": _ident("AFL-2.0"),
    "AFL-2.0": _ident("AFL-2.0"),
    "AFL-2.1": _ident("AFL-2.1"),
    "AFL-3.0": _ident("AFL-3.0"),
    "AGPL-1.0": _ident("AGPL-1.0"),
    "AGPL-3.0": _ident("AGPL-3.0"),
    "AL-2": _ident("Apache-2.0"),
    "AL-2.0": _ident("Apache-2.0"),
    "APACHE-1": _ident("Apache-1.0"),
    "APACHE-1.0": _ident("Apache-1.0"),
    "APACHE-1.1": _ident("Apache-1.1"),
    "APACHE-2": _ident("Apache-2.0"),
    "APACHE-2.0": _ident("Apache-2.0"),
    "APL-2": _ident("Apache-2.0"),
    "APL-2.0": _ident("Apache-2.0"),
    "APSL-1.0": _ident("APSL-1.0"),
    "APSL-1.1": _ident("APSL-1.1"),
    "APSL-1.2": _ident("APSL-1.2"),
    "APSL-2.0": _ident("APSL-2.0"),
    "ARTISTIC-1.0": _ident("Artistic-1.0"),
    "ARTISTIC-1.0-CL-8": _ident("Artistic-1.0-cl8"),
    "ARTISTIC-1.0-PERL": _ident("Artistic-1.0-Perl"),
    "ARTISTIC-2.0": _ident("Artistic-2.0"),
    "ASF-1": _ident("Apache-1.0"),
    "ASF-1.0": _ident("Apache-1.0"),
    "ASF-1.1": _ident("Apache-1.1"),
    "ASF-2": _ident("Apache-2.0"),
    "ASF-2.0": _ident("Apache-2.0"),
    "ASL-1": _ident("Apache-1.0"),
    "ASL-1.0": _ident("Apache-1.0"),
    "ASL-1.1": _ident("Apache-1.1"),
    "ASL-2": _ident("Apache-2.0"),
    "ASL-2.0": _ident("Apache-2.0"),
    "BCL": _ident("BCL"),
    "BEERWARE": _ident("Beerware"),
    "BOOST": _ident("BSL-1.0"),
    "BOOST-1.0": _ident("BSL-1.0"),
    "BOUNCY": _ident("MIT"),
    "BSD-2": _ident("BSD-2-Clause"),
    "BSD-2-CLAUSE": _ident("BSD-2-Clause"),
    "BSD-2-CLAUSE-FREEBSD": _ident("BSD-2-Clause-FreeBSD"),
    "BSD-2-CLAUSE-NETBSD": _ident("BSD-2-Clause-NetBSD"),
    "BSD-3": _ident("BSD-3-Clause"),
    "BSD-3-CLAUSE": _ident("BSD-3-Clause"),
    "BSD-3-CLAUSE-ATTRIBUTION": _ident("BSD-3-Clause-Attribution"),
    "BSD-3-CLAUSE-CLEAR": _ident("BSD-3-Clause-Clear"),
    "BSD-3-CLAUSE-LBNL": _ident("BSD-3-Clause-LBNL"),
    "BSD-4": _ident("BSD-4-Clause"),
    "BSD-4-CLAUSE": _ident("BSD-4-Clause"),
    "BSD-4-CLAUSE-UC": _ident("BSD-4-Clause-UC"),
    "BSD-PROTECTION": _ident("BSD-Protection"),
    "BSL": _ident("BSL-1.0"),
    "BSL-1.0": _ident("BSL-1.0"),
    "CC-BY-1.0": _ident("CC-BY-1.0"),
    "CC-BY-2.0": _ident("CC-BY-2.0"),
    "CC-BY-2.5": _ident("CC-BY-2.5"),
    "CC-BY-3.0": _ident("CC-BY-3.0"),
    "CC-BY-4.0": _ident("CC-BY-4.0"),
    "CC-BY-NC-1.0": _ident("CC-BY-NC-1.0"),
    "CC-BY-NC-2.0": _ident("CC-BY-NC-2.0"),
    "CC-BY-NC-2.5": _ident("CC-BY-NC-2.5"),
    "CC-BY-NC-3.0": _ident("CC-BY-NC-3.0"),
    "CC-BY-NC-4.0": _ident("CC-BY-NC-4.0"),
    "CC-BY-NC-ND-1.0": _ident("CC-BY-NC-ND-1.0"),
    "CC-BY-NC-ND-2.0": _ident("CC-BY-NC-ND-2.0"),
    "CC-BY-NC-ND-2.5": _ident("CC-BY-NC-ND-2.5"),
    "CC-BY-NC-ND-3.0": _ident("CC-BY-NC-ND-3.0"),
    "CC-BY-NC-ND-4.0": _ident("CC-BY-NC-ND-4.0"),
    "CC-BY-NC-SA-1.0": _ident("CC-BY-NC-SA-1.0"),
    "CC-BY-NC-SA-2.0": _ident("CC-BY-NC-SA-2.0"),
    "CC-BY-NC-SA-2.5": _ident("CC-BY-NC-SA-2.5"),
    "CC-BY-NC-SA-3.0": _ident("CC-BY-NC-SA-3.0"),
    "CC-BY-NC-SA-4.0": _ident("CC-BY-NC-SA-4.0"),
    "CC-BY-ND-1.0": _ident("CC-BY-ND-1.0"),
    "CC-BY-ND-2.0": _ident("CC-BY-ND-2.0"),
    "CC-BY-ND-2.5": _ident("CC-BY-ND-2.5"),
    "CC-BY-ND-3.0": _ident("CC-BY-ND-3.0"),
    "CC-BY-ND-4.0": _ident("CC-BY-ND-4.0"),
    "CC-BY-SA-1.0": _ident("CC-BY-SA-1.0"),
    "CC-BY-SA-2.0": _ident("CC-BY-SA-2.0"),
    "CC-BY-SA-2.5": _ident("CC-BY-SA-2.5"),
    "CC-BY-SA-3.0": _ident("CC-BY-SA-3.0"),
    "CC-BY-SA-4.0": _ident("CC-BY-SA-4.0"),
    "CC0": _ident("CC0-1.0"),
    "CC0-1.0": _ident("CC0-1.0"),
    "CDDL-1": _ident("CDDL-1.0"),
    "CDDL-1.0": _ident("CDDL-1.0"),
    "CDDL-1.1": _ident("CDDL-1.1"),
    "COMMONS-CLAUSE": _ident("Commons-Clause"),
    "CPAL": _ident("CPAL-1.0"),
    "CPAL-1.0": _ident("CPAL-1.0"),
    "CPL": _ident("CPL-1.0"),
    "CPL-1.0": _ident("CPL-1.0"),
    "ECLIPSE-1.0": _ident("EPL-1.0"),
    "ECLIPSE-2.0": _ident("EPL-2.0"),
    "EDL-1.0": _ident("BSD-3-Clause"),
    "EGENIX": _ident("eGenix"),
    "EPL-1.0": _ident("EPL-1.0"),
    "EPL-2.0": _ident("EPL-2.0"),
    "EUPL-1.0": _ident("EUPL-1.0"),
    "EUPL-1.1": _ident("EUPL-1.1"),
    "EXPAT": _ident("MIT"),
    "FREEIMAGE": _ident("FreeImage"),
    "FTL": _ident("FTL"),
    "GFDL-1.1": _ident("GFDL-1.1"),
    "GFDL-1.1-INVARIANTS": _ident("GFDL-1.1-invariants"),
    "GFDL-1.1-NO-INVARIANTS": _ident("GFDL-1.1-no-invariants"),
    "GFDL-1.2": _ident("GFDL-1.2"),
    "GFDL-1.2-INVARIANTS": _ident("GFDL-1.2-invariants"),
    "GFDL-1.2-NO-INVARIANTS": _ident("GFDL-1.2-no-invariants"),
    "GFDL-1.3": _ident("GFDL-1.3"),
    "GFDL-1.3-INVARIANTS": _ident("GFDL-1.3-invariants"),
    "GFDL-1.3-NO-INVARIANTS": _ident("GFDL-1.3-no-invariants"),
    "GFDL-NIV-1.3": _ident("GFDL-1.3-no-invariants"),
    "GO": _ident("BSD-3-Clause"),
    "GPL-1": _ident("GPL-1.0"),
    "GPL-1.0": _ident("GPL-1.0"),
    "GPL-2": _ident("GPL-2.0"),
    "GPL-2.0": _ident("GPL-2.0"),
    "GPL-2.0-WITH-AUTOCONF-EXCEPTION": _ident("GPL-2.0-with-autoconf-exception"),
    "GPL-2.0-WITH-BISON-EXCEPTION": _ident("GPL-2.0-with-bison-exception"),
    "GPL-2+-WITH-BISON-EXCEPTION": _plus("GPL-2.0-with-bison-exception"),
    "GPL-2.0-WITH-CLASSPATH-EXCEPTION": _ident("GPL-2.0-with-classpath-exception"),
    "GPL-2.0-WITH-FONT-EXCEPTION": _ident("GPL-2.0-with-font-exception"),
    "GPL-2.0-WITH-GCC-EXCEPTION": _ident("GPL-2.0-with-GCC-exception"),
    "GPL-3": _ident("GPL-3.0"),
    "GPL-3.0": _ident("GPL-3.0"),
    "GPL-3.0-WITH-AUTOCONF-EXCEPTION": _ident("GPL-3.0-with-autoconf-exception"),
    "GPL-3.0-WITH-GCC-EXCEPTION": _ident("GPL-3.0-with-GCC-exception"),
    "GPL-3+-WITH-BISON-EXCEPTION": _plus("GPL-2.0-with-bison-exception"),
    "GPLV2+CE": _plus("GPL-2.0-with-classpath-exception"),
    "GUST-FONT": _ident("GUST-Font-License"),
    "HSQLDB": _ident("BSD-3-Clause"),
    "IMAGEMAGICK": _ident("ImageMagick"),
    "IPL-1.0": _ident("IPL-1.0"),
    "ISC": _ident("ISC"),
    "ISCL": _ident("ISC"),
    "JQUERY": _ident("MIT"),
    "LGPL-2": _ident("LGPL-2.0"),
    "LGPL-2.0": _ident("LGPL-2.0"),
    "LGPL-2.1": _ident("LGPL-2.1"),
    "LGPL-3": _ident("LGPL-3.0"),
    "LGPL-3.0": _ident("LGPL-3.0"),
    "LGPLLR": _ident("LGPLLR"),
    "LIBPNG": _ident("Libpng"),
    "LIL-1.0": _ident("Lil-1.0"),
    "LINUX-OPENIB": _ident("Linux-OpenIB"),
    "LPL-1.0": _ident("LPL-1.0"),
    "LPL-1.02": _ident("LPL-1.02"),
    "LPPL-1.3C": _ident("LPPL-1.3c"),
    "MIT": _ident("MIT"),
    "MIT-0": _ident("MIT"),
    "MIT-LIKE": _ident("MIT"),
    "MIT-STYLE": _ident("MIT"),
    "MPL-1": _ident("MPL-1.0"),
    "MPL-1.0": _ident("MPL-1.0"),
    "MPL-1.1": _ident("MPL-1.1"),
    "MPL-2": _ident("MPL-2.0"),
    "MPL-2.0": _ident("MPL-2.0"),
    "MS-PL": _ident("MS-PL"),
    "NCSA": _ident("NCSA"),
    "NPL-1.0": _ident("NPL-1.0"),
    "NPL-1.1": _ident("NPL-1.1"),
    "OFL-1.1": _ident("OFL-1.1"),
    "OPENSSL": _ident("OpenSSL"),
    "OPENVISION": _ident("OpenVision"),
    "OSL-1": _ident("OSL-1.0"),
    "OSL-1.0": _ident("OSL-1.0"),
    "OSL-1.1": _ident("OSL-1.1"),
    "OSL-2": _ident("OSL-2.0"),
    "OSL-2.0": _ident("OSL-2.0"),
    "OSL-2.1": _ident("OSL-2.1"),
    "OSL-3": _ident("OSL-3.0"),
    "OSL-3.0": _ident("OSL-3.0"),
    "PHP-3.0": _ident("PHP-3.0"),
    "PHP-3.01": _ident("PHP-3.01"),
    "PIL": _ident("PIL"),
    "POSTGRESQL": _ident("PostgreSQL"),
    "PYTHON-2": _ident("Python-2.0"),
    "PYTHON-2.0": _ident("Python-2.0"),
    "PYTHON-2.0-COMPLETE": _ident("Python-2.0-complete"),
    "QPL-1": _ident("QPL-1.0"),
    "QPL-1.0": _ident("QPL-1.0"),
    "RUBY": _ident("Ruby"),
    "SGI-B-1.0": _ident("SGI-B-1.0"),
    "SGI-B-1.1": _ident("SGI-B-1.1"),
    "SGI-B-2.0": _ident("SGI-B-2.0"),
    "SISSL": _ident("SISSL"),
    "SISSL-1.2": _ident("SISSL-1.2"),
    "SLEEPYCAT": _ident("Sleepycat"),
    "UNICODE-DFS-2015": _ident("Unicode-DFS-2015"),
    "UNICODE-DFS-2016": _ident("Unicode-DFS-2016"),
    "UNICODE-TOU": _ident("Unicode-TOU"),
    "UNLICENSE": _ident("Unlicense"),
    "UNLICENSED": _ident("Unlicense"),
    "UPL-1": _ident("UPL-1.0"),
    "UPL-1.0": _ident("UPL-1.0"),
    "W3C": _ident("W3C"),
    "W3C-19980720": _ident("W3C-19980720"),
    "W3C-20150513": _ident("W3C-20150513"),
    "W3CL": _ident("W3C"),
    "WTF": _ident("WTFPL"),
    "WTFPL": _ident("WTFPL"),
    "X11": _ident("X11"),
    "XNET": _ident("Xnet"),
    "ZEND-2": _ident("Zend-2.0"),
    "ZEND-2.0": _ident("Zend-2.0"),
    "ZLIB": _ident("Zlib"),
    "ZLIB-ACKNOWLEDGEMENT": _ident("zlib-acknowledgement"),
    "ZOPE-1.1": _ident("ZPL-1.1"),
    "ZOPE-2.0": _ident("ZPL-2.0"),
    "ZOPE-2.1": _ident("ZPL-2.1"),
    "ZPL-1.1": _ident("ZPL-1.1"),
    "ZPL-2.0": _ident("ZPL-2.0"),
    "ZPL-2.1": _ident("ZPL-2.1"),
    # declared long-form names
    "ACADEMIC FREE LICENSE (AFL)": _ident("AFL-2.1"),
    "APACHE SOFTWARE LICENSES": _ident("Apache-2.0"),
    "APACHE SOFTWARE": _ident("Apache-2.0"),
    "APPLE PUBLIC SOURCE": _ident("APSL-1.0"),
    "BSD SOFTWARE": _ident("BSD-2-Clause"),
    "BSD STYLE": _ident("BSD-3-Clause"),
    "COMMON DEVELOPMENT AND DISTRIBUTION": _ident("CDDL-1.0"),
    "CREATIVE COMMONS - BY": _ident("CC-BY-3.0"),
    "CREATIVE COMMONS ATTRIBUTION": _ident("CC-BY-3.0"),
    "CREATIVE COMMONS": _ident("CC-BY-3.0"),
    "ECLIPSE PUBLIC LICENSE (EPL)": _ident("EPL-1.0"),
    "GENERAL PUBLIC LICENSE (GPL)": _plus("GPL-2.0"),
    "GNU FREE DOCUMENTATION LICENSE (FDL)": _plus("GFDL-1.3"),
    "GNU GENERAL PUBLIC LIBRARY": _plus("GPL-3.0"),
    "GNU GENERAL PUBLIC LICENSE (GPL)": _plus("GPL-3.0"),
    "GNU GPL": _ident("GPL-2.0"),
    "GNU LESSER GENERAL PUBLIC LICENSE (LGPL)": _ident("LGPL-2.1"),
    "GNU LESSER GENERAL PUBLIC": _ident("LGPL-2.1"),
    "GNU LESSER PUBLIC": _ident("LGPL-2.1"),
    "GNU LESSER": _ident("LGPL-2.1"),
    "GNU LGPL": _ident("LGPL-2.1"),
    "GNU LIBRARY OR LESSER GENERAL PUBLIC LICENSE (LGPL)": _ident("LGPL-2.1"),
    "GNU PUBLIC": _plus("GPL-2.0"),
    "GPL (WITH DUAL LICENSING OPTION)": _ident("GPL-2.0"),
    "GPLV2 WITH EXCEPTIONS": _ident("GPL-2.0-with-classpath-exception"),
    "INDIVIDUAL BSD": _ident("BSD-3-Clause"),
    "LESSER GENERAL PUBLIC LICENSE (LGPL)": _plus("LGPL-2.1"),
    "LGPL WITH EXCEPTIONS": _ident("LGPL-3.0"),
    "MOZILLA PUBLIC": _ident("MPL-2.0"),
    "ZOPE PUBLIC": _ident("ZPL-2.1"),
    "(NEW) BSD": _ident("BSD-3-Clause"),
    "2-CLAUSE BSD": _ident("BSD-2-Clause"),
    "2-CLAUSE BSDL": _ident("BSD-2-Clause"),
    "3-CLAUSE BDSL": _ident("BSD-3-Clause"),
    "3-CLAUSE BSD": _ident("BSD-3-Clause"),
    "APACHE 2 STYLE": _ident("Apache-2.0"),
    "APACHE LICENSE, ASL-2.0": _ident("Apache-2.0"),
    "APACHE VERSION 2.0, JANUARY 2004": _ident("Apache-2.0"),
    "BERKELEY SOFTWARE DISTRIBUTION (BSD)": _ident("BSD-2-Clause"),
    "BOOST SOFTWARE": _ident("BSL-1.0"),
    "BOUNCY CASTLE": _ident("MIT"),
    "BSD (3-CLAUSE)": _ident("BSD-3-Clause"),
    "BSD 2 CLAUSE": _ident("BSD-2-Clause"),
    "BSD 2-CLAUSE": _ident("BSD-2-Clause"),
    "BSD 3 CLAUSE": _ident("BSD-3-Clause"),
    "BSD 3-CLAUSE NEW": _ident("BSD-3-Clause"),
    "BSD 3-CLAUSE": _ident("BSD-3-Clause"),
    "BSD 4 CLAUSE": _ident("BSD-4-Clause"),
    "BSD 4-CLAUSE": _ident("BSD-4-Clause"),
    "BSD FOUR CLAUSE": _ident("BSD-4-Clause"),
    "BSD NEW": _ident("BSD-3-Clause"),
    "BSD THREE CLAUSE": _ident("BSD-3-Clause"),
    "BSD TWO CLAUSE": _ident("BSD-2-Clause"),
    "BSD-3 CLAUSE": _ident("BSD-3-Clause"),
    "BSD-STYLE + ATTRIBUTION": _ident("BSD-3-Clause-Attribution"),
    "CC0 1.0 UNIVERSAL": _ident("CC0-1.0"),
    "COMMON PUBLIC": _ident("CPL-1.0"),
    "COMMON PUBLIC-1.0": _ident("CPL-1.0"),
    "CREATIVE COMMONS CC0": _ident("CC0-1.0"),
    "CREATIVE COMMONS ZERO": _ident("CC0-1.0"),
    "CREATIVE COMMONS-3.0": _ident("CC-BY-3.0"),
    "ECLIPSE DISTRIBUTION LICENSE (NEW BSD LICENSE)": _ident("BSD-3-Clause"),
    "ECLIPSE DISTRIBUTION-1.0": _ident("BSD-3-Clause"),
    "ECLIPSE PUBLIC LICENSE (EPL)-1.0": _ident("EPL-1.0"),
    "ECLIPSE PUBLIC LICENSE (EPL)-2.0": _ident("EPL-2.0"),
    "ECLIPSE PUBLIC": _ident("EPL-1.0"),
    "ECLIPSE PUBLIC-1.0": _ident("EPL-1.0"),
    "ECLIPSE PUBLIC-2.0": _ident("EPL-2.0"),
    "EUROPEAN UNION PUBLIC-1.0": _ident("EUPL-1.0"),
    "EUROPEAN UNION PUBLIC-1.1": _ident("EUPL-1.1"),
    "EXPAT (MIT/X11)": _ident("MIT"),
    "MIT (MIT)": _ident("MIT"),
    "MIT / HTTP://OPENSOURCE.ORG/LICENSES/MIT": _ident("MIT"),
    "MIT-0 (HTTPS://SPDX.ORG/LICENSES/MIT-0)": _ident("MIT"),
    "THREE-CLAUSE BSD-STYLE": _ident("BSD-3-Clause"),
    "TWO-CLAUSE BSD-STYLE": _ident("BSD-2-Clause"),
    "UNIVERSAL PERMISSIVE LICENSE (UPL)": _ident("UPL-1.0"),
    "UNIVERSAL PERMISSIVE-1.0": _ident("UPL-1.0"),
    "UNLICENSE (UNLICENSE)": _ident("Unlicense"),
    "W3C SOFTWARE": _ident("W3C"),
    "ZLIB / LIBPNG": _ident("zlib-acknowledgement"),
    "ZLIB/LIBPNG": _ident("zlib-acknowledgement"),
    "['MIT']": _ident("MIT"),
    # remaining declared-name rows (generated to match the
    # reference table 1:1; see normalize.go:14-569)
    'FACEBOOK-2-CLAUSE': _ident('Facebook-2-Clause'),
    'FACEBOOK-3-CLAUSE': _ident('Facebook-3-Clause'),
    'FACEBOOK-EXAMPLES': _ident('Facebook-Examples'),
    'LPGL, SEE LICENSE FILE.': _plus('LGPL-3.0'),
    'ACADEMIC FREE LICENSE (AFL-2.1': _ident('AFL-2.1'),
    'AFFERO GENERAL PUBLIC LICENSE (AGPL-3': _ident('AGPL-3.0'),
    'APACHE LICENSE, VERSION 2.0 (HTTP://WWW.APACHE.ORG/LICENSES/LICENSE-2.0': _ident('Apache-2.0'),
    'APACHE PUBLIC-1.1': _ident('Apache-1.1'),
    'APACHE PUBLIC-2': _ident('Apache-2.0'),
    'APACHE PUBLIC-2.0': _ident('Apache-2.0'),
    'APACHE SOFTWARE LICENSE (APACHE-2': _ident('Apache-2.0'),
    'APACHE SOFTWARE LICENSE (APACHE-2.0': _ident('Apache-2.0'),
    'APACHE SOFTWARE-1.1': _ident('Apache-1.1'),
    'APACHE SOFTWARE-2': _ident('Apache-2.0'),
    'APACHE SOFTWARE-2.0': _ident('Apache-2.0'),
    'APACHE-2.0 */ &#39; &QUOT; &#X3D;END --': _ident('Apache-2.0'),
    'BOOST SOFTWARE LICENSE 1.0 (BSL-1.0': _ident('BSL-1.0'),
    'BSD - SEE NDG/HTTPSCLIENT/LICENSE FILE FOR DETAILS': _ident('BSD-3-Clause'),
    'BSD 3-CLAUSE "NEW" OR "REVISED" LICENSE (BSD-3-CLAUSE)': _ident('BSD-3-Clause'),
    'BSD LICENSE FOR HSQL': _ident('BSD-3-Clause'),
    'CC BY-NC-SA-2.0': _ident('CC-BY-NC-SA-2.0'),
    'CC BY-NC-SA-2.5': _ident('CC-BY-NC-SA-2.5'),
    'CC BY-NC-SA-3.0': _ident('CC-BY-NC-SA-3.0'),
    'CC BY-NC-SA-4.0': _ident('CC-BY-NC-SA-4.0'),
    'CC BY-SA-2.0': _ident('CC-BY-SA-2.0'),
    'CC BY-SA-2.5': _ident('CC-BY-SA-2.5'),
    'CC BY-SA-3.0': _ident('CC-BY-SA-3.0'),
    'CC BY-SA-4.0': _ident('CC-BY-SA-4.0'),
    'CC0 1.0 UNIVERSAL (CC0 1.0) PUBLIC DOMAIN DEDICATION': _ident('CC0-1.0'),
    'COMMON DEVELOPMENT AND DISTRIBUTION LICENSE (CDDL)-1.0': _ident('CDDL-1.0'),
    'COMMON DEVELOPMENT AND DISTRIBUTION LICENSE (CDDL)-1.1': _ident('CDDL-1.1'),
    'COMMON DEVELOPMENT AND DISTRIBUTION LICENSE 1.0 (CDDL-1.0': _ident('CDDL-1.0'),
    'COMMON DEVELOPMENT AND DISTRIBUTION LICENSE 1.1 (CDDL-1.1': _ident('CDDL-1.1'),
    'CREATIVE COMMONS - ATTRIBUTION 4.0 INTERNATIONAL': _ident('CC-BY-4.0'),
    'CREATIVE COMMONS 3.0 BY-SA': _ident('CC-BY-SA-3.0'),
    'CREATIVE COMMONS ATTRIBUTION 3.0 UNPORTED (CC BY-3.0': _ident('CC-BY-3.0'),
    'CREATIVE COMMONS ATTRIBUTION 4.0 INTERNATIONAL (CC BY-4.0': _ident('CC-BY-4.0'),
    'CREATIVE COMMONS ATTRIBUTION 4.0 INTERNATIONAL PUBLIC': _ident('CC-BY-4.0'),
    'CREATIVE COMMONS ATTRIBUTION-1.0': _ident('CC-BY-1.0'),
    'CREATIVE COMMONS ATTRIBUTION-2.5': _ident('CC-BY-2.5'),
    'CREATIVE COMMONS ATTRIBUTION-3.0': _ident('CC-BY-3.0'),
    'CREATIVE COMMONS ATTRIBUTION-4.0': _ident('CC-BY-4.0'),
    'CREATIVE COMMONS ATTRIBUTION-NONCOMMERCIAL 4.0 INTERNATIONAL': _ident('CC-BY-NC-4.0'),
    'CREATIVE COMMONS ATTRIBUTION-NONCOMMERCIAL-NODERIVATIVES 4.0 INTERNATIONAL': _ident('CC-BY-NC-ND-4.0'),
    'CREATIVE COMMONS ATTRIBUTION-NONCOMMERCIAL-SHAREALIKE 3.0 UNPORTED (CC BY-NC-SA-3.0': _ident('CC-BY-NC-SA-3.0'),
    'CREATIVE COMMONS ATTRIBUTION-NONCOMMERCIAL-SHAREALIKE 4.0 INTERNATIONAL PUBLIC': _ident('CC-BY-NC-SA-4.0'),
    'CREATIVE COMMONS GNU LGPL-2.1': _ident('LGPL-2.1'),
    'CREATIVE COMMONS LICENSE ATTRIBUTION-NODERIVS 3.0 UNPORTED': _ident('CC-BY-NC-ND-3.0'),
    'CREATIVE COMMONS LICENSE ATTRIBUTION-NONCOMMERCIAL-SHAREALIKE 3.0 UNPORTED': _ident('CC-BY-NC-SA-3.0'),
    'ECLIPSE DISTRIBUTION LICENSE (EDL)-1.0': _ident('BSD-3-Clause'),
    'ECLIPSE PUBLIC LICENSE 1.0 (EPL-1.0': _ident('EPL-1.0'),
    'ECLIPSE PUBLIC LICENSE 2.0 (EPL-2.0': _ident('EPL-2.0'),
    'ECLIPSE PUBLISH-1.0': _ident('EPL-1.0'),
    'EPL (ECLIPSE PUBLIC LICENSE)-1.0': _ident('EPL-1.0'),
    'EU PUBLIC LICENSE 1.0 (EUPL-1.0': _ident('EUPL-1.0'),
    'EU PUBLIC LICENSE 1.1 (EUPL-1.1': _ident('EUPL-1.1'),
    'EUROPEAN UNION PUBLIC LICENSE (EUPL-1.0': _ident('EUPL-1.0'),
    'EUROPEAN UNION PUBLIC LICENSE (EUPL-1.1': _ident('EUPL-1.1'),
    'EUROPEAN UNION PUBLIC LICENSE 1.0 (EUPL-1.0': _ident('EUPL-1.0'),
    'EUROPEAN UNION PUBLIC LICENSE 1.1 (EUPL-1.1': _ident('EUPL-1.1'),
    'GENERAL PUBLIC LICENSE 2.0 (GPL)': _ident('GPL-2.0'),
    'GNU AFFERO GENERAL PUBLIC LICENSE V3 (AGPL-3': _ident('AGPL-3.0'),
    'GNU AFFERO GENERAL PUBLIC LICENSE V3 (AGPL-3.0': _ident('AGPL-3.0'),
    'GNU AFFERO GENERAL PUBLIC LICENSE V3 OR LATER (AGPL3+)': _plus('AGPL-3.0'),
    'GNU AFFERO GENERAL PUBLIC LICENSE V3 OR LATER (AGPLV3+)': _plus('AGPL-3.0'),
    'GNU AFFERO GENERAL PUBLIC-3': _ident('AGPL-3.0'),
    'GNU FREE DOCUMENTATION LICENSE (GFDL-1.3': _ident('GFDL-1.3'),
    'GNU GENERAL LESSER PUBLIC LICENSE (LGPL)-2.1': _ident('LGPL-2.1'),
    'GNU GENERAL LESSER PUBLIC LICENSE (LGPL)-3.0': _ident('LGPL-3.0'),
    'GNU GENERAL PUBLIC LICENSE (GPL), VERSION 2, WITH CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GNU GENERAL PUBLIC LICENSE (GPL), VERSION 2, WITH THE CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GNU GENERAL PUBLIC LICENSE (GPL)-2': _ident('GPL-2.0'),
    'GNU GENERAL PUBLIC LICENSE (GPL)-3': _ident('GPL-3.0'),
    'GNU GENERAL PUBLIC LICENSE V2 (GPL-2': _ident('GPL-2.0'),
    'GNU GENERAL PUBLIC LICENSE V2 OR LATER (GPLV2+)': _plus('GPL-2.0'),
    'GNU GENERAL PUBLIC LICENSE V2.0 ONLY, WITH CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GNU GENERAL PUBLIC LICENSE V3 (GPL-3': _ident('GPL-3.0'),
    'GNU GENERAL PUBLIC LICENSE V3 OR LATER (GPLV3+)': _plus('GPL-3.0'),
    'GNU GENERAL PUBLIC LICENSE VERSION 2 (GPL-2': _ident('GPL-2.0'),
    'GNU GENERAL PUBLIC LICENSE VERSION 2, JUNE 1991': _ident('GPL-2.0'),
    'GNU GENERAL PUBLIC LICENSE VERSION 3 (GPL-3': _ident('GPL-3.0'),
    'GNU GENERAL PUBLIC LICENSE, VERSION 2 (GPL2), WITH THE CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GNU GENERAL PUBLIC LICENSE, VERSION 2 WITH THE CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GNU GENERAL PUBLIC LICENSE, VERSION 2 WITH THE GNU CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GNU GENERAL PUBLIC LICENSE, VERSION 2, WITH THE CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GNU GENERAL PUBLIC-2': _ident('GPL-2.0'),
    'GNU GENERAL PUBLIC-3': _ident('GPL-3.0'),
    'GNU GPL-2': _ident('GPL-2.0'),
    'GNU GPL-3': _ident('GPL-3.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL)-2': _ident('LGPL-2.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL)-2.0': _ident('LGPL-2.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL)-2.1': _ident('LGPL-2.1'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL)-3': _ident('LGPL-3.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL)-3.0': _ident('LGPL-3.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL-2': _ident('LGPL-2.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL-2.0': _ident('LGPL-2.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL-2.1': _ident('LGPL-2.1'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL-3': _ident('LGPL-3.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE (LGPL-3.0': _ident('LGPL-3.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE V2 (LGPL-2': _ident('LGPL-2.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE V2 OR LATER (LGPLV2+)': _plus('LGPL-2.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE V3 (LGPL-3': _ident('LGPL-3.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE V3 OR LATER (LGPLV3+)': _plus('LGPL-3.0'),
    'GNU LESSER GENERAL PUBLIC LICENSE VERSION 2.1 (LGPL-2.1': _ident('LGPL-2.1'),
    'GNU LESSER GENERAL PUBLIC LICENSE VERSION 2.1, FEBRUARY 1999': _ident('LGPL-2.1'),
    'GNU LESSER GENERAL PUBLIC LICENSE, VERSION 2.1, FEBRUARY 1999': _ident('LGPL-2.1'),
    'GNU LESSER GENERAL PUBLIC-2': _ident('LGPL-2.0'),
    'GNU LESSER GENERAL PUBLIC-2.0': _ident('LGPL-2.0'),
    'GNU LESSER GENERAL PUBLIC-2.1': _ident('LGPL-2.1'),
    'GNU LESSER GENERAL PUBLIC-3': _ident('LGPL-3.0'),
    'GNU LESSER GENERAL PUBLIC-3.0': _ident('LGPL-3.0'),
    'GNU LGP (GNU GENERAL PUBLIC LICENSE)-2': _ident('LGPL-2.0'),
    'GNU LGPL (GNU LESSER GENERAL PUBLIC LICENSE)-2.1': _ident('LGPL-2.1'),
    'GNU LGPL-2': _ident('LGPL-2.0'),
    'GNU LGPL-2.0': _ident('LGPL-2.0'),
    'GNU LGPL-2.1': _ident('LGPL-2.1'),
    'GNU LGPL-3': _ident('LGPL-3.0'),
    'GNU LGPL-3.0': _ident('LGPL-3.0'),
    'GNU LIBRARY GENERAL PUBLIC-2.0': _ident('LGPL-2.0'),
    'GNU LIBRARY GENERAL PUBLIC-2.1': _ident('LGPL-2.1'),
    'GNU LIBRARY OR LESSER GENERAL PUBLIC LICENSE VERSION 2.0 (LGPL-2': _ident('LGPL-2.0'),
    'GNU LIBRARY OR LESSER GENERAL PUBLIC LICENSE VERSION 3.0 (LGPL-3': _ident('LGPL-3.0'),
    'GPL (≥ 3)': _plus('GPL-3.0'),
    'GPL 2 WITH CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GPL V2 WITH CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GPL-2+ WITH AUTOCONF EXCEPTION': _plus('GPL-2.0-with-autoconf-exception'),
    'GPL-3+ WITH AUTOCONF EXCEPTION': _plus('GPL-3.0-with-autoconf-exception'),
    'GPL2 W/ CPE': _ident('GPL-2.0-with-classpath-exception'),
    'GPLV2 LICENSE, INCLUDES THE CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'GPLV2 WITH CLASSPATH EXCEPTION': _ident('GPL-2.0-with-classpath-exception'),
    'HSQLDB LICENSE, A BSD OPEN SOURCE': _ident('BSD-3-Clause'),
    'HTTP://ANT-CONTRIB.SOURCEFORGE.NET/TASKS/LICENSE.TXT': _ident('Apache-1.1'),
    'HTTP://ASM.OW2.ORG/LICENSE.HTML': _ident('BSD-3-Clause'),
    'HTTP://CREATIVECOMMONS.ORG/PUBLICDOMAIN/ZERO/1.0/LEGALCODE': _ident('CC0-1.0'),
    'HTTP://EN.WIKIPEDIA.ORG/WIKI/ZLIB_LICENSE': _ident('Zlib'),
    'HTTP://JSON.CODEPLEX.COM/LICENSE': _ident('MIT'),
    'HTTP://POLYMER.GITHUB.IO/LICENSE.TXT': _ident('BSD-3-Clause'),
    'HTTP://WWW.APACHE.ORG/LICENSES/LICENSE-2.0': _ident('Apache-2.0'),
    'HTTP://WWW.APACHE.ORG/LICENSES/LICENSE-2.0.HTML': _ident('Apache-2.0'),
    'HTTP://WWW.APACHE.ORG/LICENSES/LICENSE-2.0.TXT': _ident('Apache-2.0'),
    'HTTP://WWW.GNU.ORG/COPYLEFT/LESSER.HTML': _ident('LGPL-3.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-ND/1.0': _ident('CC-BY-NC-ND-1.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-ND/2.0': _ident('CC-BY-NC-ND-2.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-ND/2.5': _ident('CC-BY-NC-ND-2.5'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-ND/3.0': _ident('CC-BY-NC-ND-3.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-ND/4.0': _ident('CC-BY-NC-ND-4.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-SA/1.0': _ident('CC-BY-NC-SA-1.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-SA/2.0': _ident('CC-BY-NC-SA-2.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-SA/2.5': _ident('CC-BY-NC-SA-2.5'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-SA/3.0': _ident('CC-BY-NC-SA-3.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-NC-SA/4.0': _ident('CC-BY-NC-SA-4.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-ND/1.0': _ident('CC-BY-ND-1.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-ND/2.0': _ident('CC-BY-ND-2.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-ND/2.5': _ident('CC-BY-ND-2.5'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-ND/3.0': _ident('CC-BY-ND-3.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-ND/4.0': _ident('CC-BY-ND-4.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-SA/1.0': _ident('CC-BY-SA-1.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-SA/2.0': _ident('CC-BY-SA-2.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-SA/2.5': _ident('CC-BY-SA-2.5'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-SA/3.0': _ident('CC-BY-SA-3.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY-SA/4.0': _ident('CC-BY-SA-4.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY/1.0': _ident('CC-BY-1.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY/2.0': _ident('CC-BY-2.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY/2.5': _ident('CC-BY-2.5'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY/3.0': _ident('CC-BY-3.0'),
    'HTTPS://CREATIVECOMMONS.ORG/LICENSES/BY/4.0': _ident('CC-BY-4.0'),
    'HTTPS://CREATIVECOMMONS.ORG/PUBLICDOMAIN/ZERO/1.0/': _ident('CC0-1.0'),
    'HTTPS://GITHUB.COM/DOTNET/CORE-SETUP/BLOB/MASTER/LICENSE.TXT': _ident('MIT'),
    'HTTPS://GITHUB.COM/DOTNET/COREFX/BLOB/MASTER/LICENSE.TXT': _ident('MIT'),
    'HTTPS://RAW.GITHUB.COM/RDFLIB/RDFLIB/MASTER/LICENSE': _ident('BSD-3-Clause'),
    'HTTPS://RAW.GITHUBUSERCONTENT.COM/ASPNET/ASPNETCORE/2.0.0/LICENSE.TXT': _ident('Apache-2.0'),
    'HTTPS://RAW.GITHUBUSERCONTENT.COM/ASPNET/HOME/2.0.0/LICENSE.TXT': _ident('Apache-2.0'),
    'HTTPS://RAW.GITHUBUSERCONTENT.COM/NUGET/NUGET.CLIENT/DEV/LICENSE.TXT': _ident('Apache-2.0'),
    'HTTPS://WWW.APACHE.ORG/LICENSES/LICENSE-2.0': _ident('Apache-2.0'),
    'HTTPS://WWW.ECLIPSE.ORG/LEGAL/EPL-V10.HTML': _ident('EPL-1.0'),
    'HTTPS://WWW.ECLIPSE.ORG/LEGAL/EPL-V20.HTML': _ident('EPL-2.0'),
    'IBM PUBLIC': _ident('IPL-1.0'),
    'ISC LICENSE (ISCL)': _ident('ISC'),
    'JYTHON SOFTWARE': _ident('Python-2.0'),
    'KIRKK.COM BSD': _ident('BSD-3-Clause'),
    'LESSER GENERAL PUBLIC LICENSE, VERSION 3 OR GREATER': _plus('LGPL-3.0'),
    'LICENSE AGREEMENT FOR OPEN SOURCE COMPUTER VISION LIBRARY (3-CLAUSE BSD LICENSE)': _ident('BSD-3-Clause'),
    'MIT (HTTP://MOOTOOLS.NET/LICENSE.TXT)': _ident('MIT'),
    'MIT / HTTP://REM.MIT-LICENSE.ORG': _ident('MIT'),
    'MIT LICENSE (HTTP://OPENSOURCE.ORG/LICENSES/MIT)': _ident('MIT'),
    'MIT LICENSE (MIT)': _ident('MIT'),
    'MIT LICENSE(MIT)': _ident('MIT'),
    'MIT LICENSED. HTTP://WWW.OPENSOURCE.ORG/LICENSES/MIT-LICENSE.PHP': _ident('MIT'),
    'MIT/EXPAT': _ident('MIT'),
    'MOCKRUNNER LICENSE, BASED ON APACHE SOFTWARE-1.1': _ident('Apache-1.1'),
    'MODIFIED BSD': _ident('BSD-3-Clause'),
    'MOZILLA PUBLIC LICENSE 1.0 (MPL)': _ident('MPL-1.0'),
    'MOZILLA PUBLIC LICENSE 1.1 (MPL-1.1': _ident('MPL-1.1'),
    'MOZILLA PUBLIC LICENSE 2.0 (MPL-2.0': _ident('MPL-2.0'),
    'MOZILLA PUBLIC-1.0': _ident('MPL-1.0'),
    'MOZILLA PUBLIC-1.1': _ident('MPL-1.1'),
    'MOZILLA PUBLIC-2.0': _ident('MPL-2.0'),
    'NCSA OPEN SOURCE': _ident('NCSA'),
    'NETSCAPE PUBLIC LICENSE (NPL)': _ident('NPL-1.0'),
    'NETSCAPE PUBLIC': _ident('NPL-1.0'),
    'NEW BSD': _ident('BSD-3-Clause'),
    'OPEN SOFTWARE LICENSE 3.0 (OSL-3.0': _ident('OSL-3.0'),
    'OPEN SOFTWARE-3.0': _ident('OSL-3.0'),
    'PERL ARTISTIC-2': _ident('Artistic-1.0-Perl'),
    'PUBLIC DOMAIN (CC0-1.0)': _ident('CC0-1.0'),
    'PUBLIC DOMAIN, PER CREATIVE COMMONS CC0': _ident('CC0-1.0'),
    'QT PUBLIC LICENSE (QPL)': _ident('QPL-1.0'),
    'QT PUBLIC': _ident('QPL-1.0'),
    'REVISED BSD': _ident('BSD-3-Clause'),
    "RUBY'S": _ident('Ruby'),
    'SEQUENCE LIBRARY LICENSE (BSD-LIKE)': _ident('BSD-3-Clause'),
    'SIL OPEN FONT LICENSE 1.1 (OFL-1.1': _ident('OFL-1.1'),
    'SIL OPEN FONT-1.1': _ident('OFL-1.1'),
    'SIMPLIFIED BSD LISCENCE': _ident('BSD-2-Clause'),
    'SIMPLIFIED BSD': _ident('BSD-2-Clause'),
    'SUN INDUSTRY STANDARDS SOURCE LICENSE (SISSL)': _ident('SISSL'),
    "PUBLIC DOMAIN": _ident("Unlicense"),
}

# reference normalize.go:578-583 — python classifiers we cannot split on
# and/or; keyed by the first word after the separator.
_PYTHON_EXCEPTIONS = {
    "lesser": "GNU Library or Lesser General Public License (LGPL)",
    "distribution": "Common Development and Distribution License 1.0 (CDDL-1.0)",
    "disclaimer": "Historical Permission Notice and Disclaimer (HPND)",
}

_SPLIT_RE = re.compile(r"(?:,?[_ ]+(?:or|and)[_ ]+)|(?:,[ ]*)")

_TEXT_KEYWORDS = (
    "http://", "https://", "(c)", "as-is", ";", "hereby",
    "permission to use", "permission is", "use in source",
    "use, copy, modify", "using",
)

# "X LICENSE, VERSION 2.0" / "X V2" / "X-V.2" → "X-2.0" style folding
_VERSION_PART = (
    r"([A-UW-Z)])( LICENSE)?\s*[,(-]?\s*"
    r"(V|V\.|VER|VER\.|VERSION|VERSION-|-)?\s*([1-9](\.\d)*)[)]?"
)
_VERSION_SUFFIX_RE = re.compile(_VERSION_PART + r"$")
_VERSION_ANY_RE = re.compile(_VERSION_PART, re.IGNORECASE)

_PLUS_SUFFIXES = ("+", "-OR-LATER", " OR LATER")
_ONLY_SUFFIXES = ("-ONLY", " ONLY")


def _standardize(name: str) -> SimpleExpr:
    """Uppercase, strip affixes, fold version suffix, extract plus
    (reference normalize.go:641-675)."""
    name = " ".join(name.split()).upper()
    if name.startswith("HTTP"):
        return SimpleExpr(name)
    name = name.replace("LICENCE", "LICENSE")
    name = name.removeprefix("THE ")
    for suf in (" LICENSE", " LICENSED", "-LICENSE", "-LICENSED"):
        name = name.removesuffix(suf)
    if name != "UNLICENSE":
        name = name.removesuffix("LICENSE")
    if name != "UNLICENSED":
        name = name.removesuffix("LICENSED")
    has_plus = False
    for suf in _PLUS_SUFFIXES:
        if name.endswith(suf):
            name = name.removesuffix(suf)
            has_plus = True
    for suf in _ONLY_SUFFIXES:
        name = name.removesuffix(suf)
    name = _VERSION_SUFFIX_RE.sub(r"\1-\4", name)
    return SimpleExpr(name, has_plus)


def _normalize_simple(e: SimpleExpr):
    name = e.license.strip()
    std = _standardize(name)
    found = _MAPPING.get(std.license)
    if found:
        return SimpleExpr(found[0], e.has_plus or found[1] or std.has_plus)
    return SimpleExpr(name, e.has_plus)


def normalize_license(expr):
    """Normalize a parsed expression node (reference normalize.go:682-691)."""
    if isinstance(expr, SimpleExpr):
        return _normalize_simple(expr)
    if isinstance(expr, CompoundExpr) and expr.op == "WITH":
        std = _standardize(str(expr))
        found = _MAPPING.get(std.license)
        if found:
            return SimpleExpr(found[0], found[1] or std.has_plus)
    return expr


def normalize(name: str) -> str:
    """Normalize a single free-form license name to its SPDX id."""
    return str(normalize_license(SimpleExpr(name)))


def normalize_spdx_expression(text: str) -> str:
    """Parse a full SPDX expression and normalize every leaf; returns
    the input unchanged when it does not parse."""
    try:
        expr = parse(text)
    except ValueError:
        return normalize(text)
    return str(normalize_expression(expr, normalize_license))


def is_license_text(s: str) -> bool:
    low = s.lower()
    return any(k in low for k in _TEXT_KEYWORDS)


def trim_license_text(text: str) -> str:
    words = text.split(" ")
    return " ".join(words[:3]) + "..."


def split_licenses(s: str) -> list[str]:
    """Split a declared-license string on ','/'or'/'and' separators with
    the version/later/python-classifier re-join rules
    (reference normalize.go:712-746)."""
    if not s:
        return []
    if is_license_text(s.lower()):
        return [LICENSE_TEXT_PREFIX + s]
    licenses: list[str] = []
    for maybe in _SPLIT_RE.split(s):
        if maybe is None:
            continue
        first = maybe.lower().split(" ", 1)[0]
        if licenses:
            if first in ("ver", "version"):
                licenses[-1] += ", " + maybe
                continue
            if first == "later":
                licenses[-1] += " or " + maybe
                continue
            if first in _PYTHON_EXCEPTIONS:
                full = _PYTHON_EXCEPTIONS[first]
                if full in (licenses[-1] + " or " + maybe,
                            licenses[-1] + " and " + maybe):
                    licenses[-1] = full
                continue
        licenses.append(maybe)
    return licenses


def lax_split_licenses(s: str) -> list[str]:
    """Space-separated split for messy fields like dpkg copyright
    (reference normalize.go:750-767)."""
    if not s:
        return []
    s = _VERSION_ANY_RE.sub(lambda m: f"{m.group(1)}-{m.group(4)}", s.upper())
    out = []
    for word in s.split():
        word = word.strip("()")
        if not word or word in ("AND", "OR"):
            continue
        out.append(normalize(word))
    return out
