"""License full-text classification for `--license-full` scans.

The reference delegates to google/licenseclassifier v2
(pkg/licensing/classifier.go:36-87), a token-ngram matcher over the
SPDX corpus.  Shipping the full corpus is out of scope here; the same
ALGORITHM runs over distinctive excerpts of the licenses that dominate
real artifacts: each license compiles to a set of word trigrams, a
document's trigram set is intersected with it, and confidence is the
contained fraction — tolerant of reflowed text, punctuation and small
edits, unlike exact phrase search.  Explicit `SPDX-License-Identifier:`
tags classify at confidence 1.0.  Findings below the confidence level
are dropped, mirroring classifier.go:57-60.

Custom corpora extend coverage: `add_license_text(name, text)` compiles
any license body into the matcher at runtime.

Two interchangeable trigram engines back `classify`: the reference
set-of-tuples matcher, and a vectorized engine that interns corpus
words to dense ids, packs each trigram into one int64
(21 bits/word), and intersects sorted unique arrays with
`np.isin` — the same crunch-lane idiom the detector uses for
advisory screening.  Both engines produce identical confidences by
construction (a document trigram containing any out-of-corpus word
can never equal a corpus trigram, and the confidence denominator
only counts corpus grams); `TRIVY_TPU_VECTOR_ANALYZERS=0` or an
overflowing vocabulary falls back to the set engine.

Copy of trivy_tpu/licensing/classifier.py, whole, with its imports rewritten.
"""

from __future__ import annotations

import os
import re

from trivy_tpu_torch.types.artifact import LicenseFile, LicenseFinding

# File type markers (reference fanal/types: LicenseTypeHeader / File)
TYPE_HEADER = "header"
TYPE_FILE = "license-file"

_SPDX_TAG_RE = re.compile(
    r"SPDX-License-Identifier:\s*([A-Za-z0-9+.\-() ]+?)\s*(?:\*/|-->|$)",
    re.MULTILINE,
)

# Phrases are matched against lowercased text with collapsed whitespace
# and stripped punctuation.  Every phrase list starts with the most
# distinctive sentence of the license body.
_FINGERPRINTS: dict[str, list[str]] = {
    "MIT": [
        "permission is hereby granted free of charge to any person "
        "obtaining a copy of this software",
        "the software is provided as is without warranty of any kind",
        "subject to the following conditions",
    ],
    "Apache-2.0": [
        "apache license version 2 0",
        "licensed under the apache license version 2 0",
        "unless required by applicable law or agreed to in writing",
        "www apache org licenses license 2 0",
    ],
    "BSD-3-Clause": [
        "redistribution and use in source and binary forms",
        "neither the name of",
        "this software is provided by the copyright holders and "
        "contributors as is",
    ],
    "BSD-2-Clause": [
        "redistribution and use in source and binary forms",
        "this software is provided by the copyright holders and "
        "contributors as is",
    ],
    "GPL-2.0": [
        "gnu general public license version 2",
        "free software foundation either version 2 of the license",
        "this program is distributed in the hope that it will be useful",
    ],
    "GPL-3.0": [
        "gnu general public license version 3",
        "free software foundation either version 3 of the license",
        "this program is distributed in the hope that it will be useful",
    ],
    "LGPL-2.1": [
        "gnu lesser general public license version 2 1",
        "free software foundation either version 2 1 of the license",
    ],
    "LGPL-3.0": [
        "gnu lesser general public license version 3",
        "free software foundation either version 3 of the license",
    ],
    "AGPL-3.0": [
        "gnu affero general public license",
        "free software foundation either version 3 of the license",
    ],
    "MPL-2.0": [
        "mozilla public license version 2 0",
        "this source code form is subject to the terms of the mozilla "
        "public license v 2 0",
    ],
    "ISC": [
        "permission to use copy modify and or distribute this software "
        "for any purpose with or without fee is hereby granted",
        "the software is provided as is and the author disclaims all "
        "warranties",
    ],
    "Unlicense": [
        "this is free and unencumbered software released into the "
        "public domain",
        "in jurisdictions that recognize copyright laws",
    ],
    "CC0-1.0": [
        "cc0 1 0 universal",
        "the person who associated a work with this deed has dedicated "
        "the work to the public domain",
    ],
    "EPL-2.0": [
        "eclipse public license v 2 0",
        "this program and the accompanying materials are made available "
        "under the terms of the eclipse public license 2 0",
    ],
    "EPL-1.0": [
        "eclipse public license v 1 0",
    ],
    "Zlib": [
        "this software is provided as is without any express or implied "
        "warranty",
        "altered source versions must be plainly marked as such",
        "the origin of this software must not be misrepresented",
    ],
    "BSL-1.0": [
        "boost software license version 1 0",
        "permission is hereby granted free of charge to any person or "
        "organization obtaining a copy of the software",
    ],
    "WTFPL": [
        "do what the fuck you want to public license",
    ],
    "PostgreSQL": [
        "permission to use copy modify and distribute this software and "
        "its documentation for any purpose without fee",
        "in no event shall the university of california be liable",
    ],
    "OpenSSL": [
        "this product includes software developed by the openssl project",
    ],
    "Artistic-2.0": [
        # NB: the "everyone is permitted to copy and distribute verbatim
        # copies" sentence is shared with every GNU license preamble and
        # must not be used as a fingerprint
        "the artistic license 2 0",
        "aggregating or linking the package",
    ],
    "OFL-1.1": [
        "sil open font license version 1 1",
    ],
    "CDDL-1.0": [
        "common development and distribution license cddl version 1 0",
    ],
    "EUPL-1.2": [
        "european union public licence v 1 2",
    ],
    "MS-PL": [
        "microsoft public license ms pl",
    ],
}

_NORM_RE = re.compile(r"[^a-z0-9]+")

_NGRAM = 3


def _ngrams(text: str) -> set[tuple[str, ...]]:
    words = text.split()
    if len(words) < _NGRAM:
        return {tuple(words)} if words else set()
    return {tuple(words[i:i + _NGRAM])
            for i in range(len(words) - _NGRAM + 1)}


# ------------------------------------------------- packed trigram engine
#
# Corpus words intern to dense ids starting at 1 (0 is the shared
# out-of-corpus id); a trigram packs into one int64 as three 21-bit
# fields.  Grams shorter than the trigram width (phrases under three
# words) stay as Python tuples in a side set — they can never collide
# with a packed value.

_PACK_BITS = 21
_PACK_MAX = (1 << _PACK_BITS) - 1
_VOCAB: dict[str, int] = {}
_PACKED: dict[str, tuple] = {}      # name -> (excerpt|None, [fulls])
_pack_disabled = False


def _vector_enabled() -> bool:
    return (not _pack_disabled
            and os.environ.get("TRIVY_TPU_VECTOR_ANALYZERS", "1") != "0")


def _intern(words: list[str], grow: bool):
    """Map words to dense ids; `grow` extends the vocabulary (corpus
    compile) while documents map unknown words to the OOV id 0."""
    global _pack_disabled
    import numpy as np

    if grow:
        ids = np.empty(len(words), dtype=np.int64)
        for i, w in enumerate(words):
            wid = _VOCAB.get(w)
            if wid is None:
                wid = len(_VOCAB) + 1
                if wid > _PACK_MAX:
                    _pack_disabled = True
                    return None
                _VOCAB[w] = wid
            ids[i] = wid
        return ids
    return np.fromiter((_VOCAB.get(w, 0) for w in words),
                       dtype=np.int64, count=len(words))


def _pack(ids):
    import numpy as np

    packed = ((ids[:-2] << (2 * _PACK_BITS))
              | (ids[1:-1] << _PACK_BITS) | ids[2:])
    return np.unique(packed)


def _compile_packed(texts) -> tuple:
    """Union of the texts' gram sets as (sorted unique packed trigram
    array, frozenset of short grams); None while overflowed."""
    import numpy as np

    arrs, short = [], set()
    for t in texts:
        words = t.split()
        if not words:
            continue
        if len(words) < _NGRAM:
            short.add(tuple(words))
        else:
            ids = _intern(words, grow=True)
            if ids is None:
                return None
            arrs.append(_pack(ids))
    arr = (np.unique(np.concatenate(arrs)) if arrs
           else np.empty(0, dtype=np.int64))
    return arr, frozenset(short)


def _packed_sets(name: str):
    """Packed analogue of `_gram_sets` (same variants, same shapes)."""
    compiled = _PACKED.get(name)
    if compiled is None:
        excerpt = _compile_packed(_FINGERPRINTS.get(name, ()))
        fulls = [_compile_packed([t])
                 for t in _EXTRA_VARIANTS.get(name, ())]
        if excerpt is None or any(f is None for f in fulls):
            return None                          # vocabulary overflow
        if not (excerpt[0].size or excerpt[1]):
            excerpt = None
        compiled = (excerpt, fulls)
        _PACKED[name] = compiled
    return compiled


def _packed_conf(compiled, doc_arr, doc_short) -> float:
    """|corpus grams ∩ doc grams| / |corpus grams|, packed form."""
    import numpy as np

    arr, short = compiled
    total = arr.size + len(short)
    if not total:
        return 0.0
    hits = 0
    if arr.size and doc_arr.size:
        hits = int(np.isin(arr, doc_arr, assume_unique=True).sum())
    if short and doc_short:
        hits += len(short & doc_short)
    return hits / total


_GRAM_SETS: dict[str, list[set]] = {}

# extra whole-text variants per license (the embedded SPDX corpus and
# any user-supplied bodies); each variant matches independently so a
# short distinctive excerpt and a full license body never dilute each
# other's confidence denominator
_EXTRA_VARIANTS: dict[str, list[str]] = {}
_corpus_loaded = False


def _load_corpus() -> None:
    global _corpus_loaded
    if _corpus_loaded:
        return
    _corpus_loaded = True
    from trivy_tpu_torch.licensing.corpus import TEXTS

    for name, text in TEXTS.items():
        _EXTRA_VARIANTS.setdefault(name, []).append(
            _normalize_text(text))
        _GRAM_SETS.pop(name, None)
        _PACKED.pop(name, None)


def _gram_sets(name: str):
    """Compiled word-trigram variants: (excerpt union | None,
    [whole-text gram sets]). Confidence is the max over variants, with
    whole-text matches tracked separately (they outrank excerpt hits in
    the family disambiguation below)."""
    grams = _GRAM_SETS.get(name)
    if grams is None:
        excerpt = set()
        for phrase in _FINGERPRINTS.get(name, ()):
            excerpt |= _ngrams(phrase)
        grams = (excerpt or None,
                 [_ngrams(t) for t in _EXTRA_VARIANTS.get(name, ())])
        _GRAM_SETS[name] = grams
    return grams


def add_license_text(name: str, text: str) -> None:
    """Extend the matcher with a license body (user corpus)."""
    _EXTRA_VARIANTS.setdefault(name, []).append(_normalize_text(text))
    _FINGERPRINTS.setdefault(name, [])
    _GRAM_SETS.pop(name, None)
    _PACKED.pop(name, None)


def _score_sets(norm: str) -> list[tuple[str, float, float]]:
    """Reference engine: (name, excerpt conf, whole-text conf) per
    license, via set-of-tuple trigram intersections."""
    doc_grams = _ngrams(norm)
    out = []
    for name in sorted(set(_FINGERPRINTS) | set(_EXTRA_VARIANTS)):
        excerpt, fulls = _gram_sets(name)
        conf_ex = (len(excerpt & doc_grams) / len(excerpt)
                   if excerpt else 0.0)
        conf_full = max((len(g & doc_grams) / len(g)
                         for g in fulls if g), default=0.0)
        out.append((name, conf_ex, conf_full))
    return out


def _score_packed(norm: str) -> list[tuple[str, float, float]] | None:
    """Vectorized engine: identical confidences to `_score_sets`, or
    None when numpy is unavailable / the vocabulary overflowed."""
    global _pack_disabled
    try:
        import numpy as np
    except ImportError:            # pragma: no cover - numpy is baked in
        _pack_disabled = True
        return None

    names = sorted(set(_FINGERPRINTS) | set(_EXTRA_VARIANTS))
    compiled = []
    for name in names:
        c = _packed_sets(name)
        if c is None:
            return None                          # vocabulary overflow
        compiled.append(c)

    words = norm.split()
    doc_short: set[tuple[str, ...]] = set()
    if len(words) < _NGRAM:
        doc_arr = np.empty(0, dtype=np.int64)
        if words:
            doc_short = {tuple(words)}
    else:
        doc_arr = _pack(_intern(words, grow=False))

    out = []
    for name, (excerpt, fulls) in zip(names, compiled):
        conf_ex = (_packed_conf(excerpt, doc_arr, doc_short)
                   if excerpt is not None else 0.0)
        conf_full = max((_packed_conf(f, doc_arr, doc_short)
                         for f in fulls), default=0.0)
        out.append((name, conf_ex, conf_full))
    return out


def _finding(name: str, confidence: float) -> LicenseFinding:
    return LicenseFinding(
        name=name, confidence=confidence,
        link=f"https://spdx.org/licenses/{name}.html",
    )


def _normalize_text(data: bytes | str) -> str:
    if isinstance(data, bytes):
        data = data.decode("utf-8", errors="replace")
    return _NORM_RE.sub(" ", data.lower()).strip()


def classify(file_path: str, content: bytes | str,
             confidence_level: float = 0.75) -> LicenseFile | None:
    """Classify license text in a file; None when nothing matches."""
    raw = content.decode("utf-8", errors="replace") \
        if isinstance(content, bytes) else content

    findings: list[LicenseFinding] = []
    seen: set[str] = set()
    match_type = TYPE_FILE

    for m in _SPDX_TAG_RE.finditer(raw):
        expr = m.group(1).strip()
        for name in re.split(r"\s+(?:AND|OR|WITH)\s+|[()]", expr):
            name = name.strip()
            if name and name not in seen:
                seen.add(name)
                findings.append(_finding(name, 1.0))
        match_type = TYPE_HEADER

    norm = _normalize_text(raw)
    full_conf: dict[str, float] = {}
    if norm:
        _load_corpus()
        scores = (_score_packed(norm) if _vector_enabled() else None)
        if scores is None:
            scores = _score_sets(norm)
        for name, conf_ex, conf_full in scores:
            if name in seen:
                continue
            conf = max(conf_ex, conf_full)
            if conf >= confidence_level:
                seen.add(name)
                full_conf[name] = conf_full
                findings.append(_finding(name, round(conf, 2)))
                match_type = TYPE_FILE

    # the GNU family shares preamble/boilerplate: a near-exact match of
    # one member (full-text variant >= 0.95) outranks partial matches of
    # its siblings
    gnu = {"GPL-2.0", "GPL-3.0", "LGPL-2.1", "LGPL-3.0", "AGPL-3.0"}
    fam = [f for f in findings if f.name in gnu]
    if len(fam) > 1:
        best_full = max(full_conf.get(f.name, 0.0) for f in fam)
        if best_full >= 0.95:
            # a near-exact whole-text match outranks siblings that only
            # hit shared preamble/excerpt phrases
            for f in fam:
                if full_conf.get(f.name, 0.0) < best_full:
                    findings.remove(f)
        else:
            best = max(f.confidence for f in fam)
            if best >= 0.95:
                for f in fam:
                    if f.confidence < best:
                        findings.remove(f)

    # BSD-2 fingerprint is a subset of BSD-3; prefer the more specific hit
    names = {f.name for f in findings}
    if "BSD-3-Clause" in names and "BSD-2-Clause" in names:
        bsd3 = next(f for f in findings if f.name == "BSD-3-Clause")
        bsd2 = next(f for f in findings if f.name == "BSD-2-Clause")
        if bsd3.confidence >= bsd2.confidence:
            findings.remove(bsd2)

    if not findings:
        return None
    findings.sort(key=lambda f: (-f.confidence, f.name))
    return LicenseFile(type=match_type, file_path=file_path, findings=findings)
