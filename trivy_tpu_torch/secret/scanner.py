"""Secret scanner (reference pkg/fanal/secret/scanner.go).

Port of trivy_tpu/secret/scanner.py. Scan pipeline per file
(scanner.go:377-463):
  keyword prefilter -> regex findall -> allow-rule filtering -> censor the
  secret group -> line-context extraction.

Custom rules/allow-rules/exclude-blocks load from a YAML config
(scanner.go:277 ParseConfig). The device path screens all files at once
on a CUDA card (ops/secret_nfa.py: every rule and keyword compiles to
an anchor, one kernel evaluates every anchor over a batch of 16 KiB
chunks) and the host regex runs only inside the candidate windows the
screen reports.

The device runs on ``cuda:0`` unless the caller passes ``device="cpu"``
(the screen's plain PyTorch version). ``use_device=False`` stays the
explicit host path. The ``secret.device`` fault ladder is the
reference's: a screen that is unavailable (``ScreenUnavailable``) or a
card that is lost (``faults.DeviceLost``) degrades that scan to the
host scanner with zero finding diff, counted in
``device_stats["degraded"]`` and ``trivy_tpu_degraded_total``. Unlike
the reference, which falls back on any exception, every other failure
of the device screen (a kernel that does not build or launch, a CUDA
error) raises.

One scanner may serve several threads at once (an image scan's walk
lanes share the analyzer's scanner): the lazy builds run once under a
lock, and `device_stats` is added to under a lock, with each thread's
own additions readable through `stats_scope()`. The anchor screens of
concurrent scans coalesce in the scanner's secret-lane scheduler
(sched/scheduler.py, rows of 16 KiB chunks) into shared dispatches;
`TRIVY_TPU_SCHED=0` dispatches each scan's chunks directly. `close()`
stops the lane's thread.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Literal

import numpy as np

from trivy_tpu_torch.analysis.witness import make_lock
from trivy_tpu_torch.device import resolve_device
from trivy_tpu_torch.log import logger
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import tracing
from trivy_tpu_torch.obs import usage
from trivy_tpu_torch.ops import secret_nfa as nfa
from trivy_tpu_torch.resilience import faults
from trivy_tpu_torch.secret.rules import (
    BUILTIN_ALLOW_RULES,
    BUILTIN_RULES,
    SKIP_EXTENSIONS,
    AllowRule,
    Rule,
)
from trivy_tpu_torch.types.artifact import Secret, SecretFinding

_log = logger("secret")


class ScreenUnavailable(RuntimeError):
    """The device anchor screen cannot serve this dispatch (an injected
    ``secret.device`` drop or error): callers degrade to the host
    scanner with zero finding diff."""


# what the secret.device ladder degrades on; any other error raises
DEGRADE_ON = (ScreenUnavailable, faults.DeviceLost)


def _pack_chunks() -> int | None:
    """Device super-buffer size: ``TRIVY_TPU_SECRET_PACK_MB`` MiB of
    packed 16 KiB chunks per anchor-screen dispatch. None = the
    matcher's per-bank default."""
    raw = os.environ.get("TRIVY_TPU_SECRET_PACK_MB", "")
    if not raw:
        return None
    try:
        mb = float(raw)
    except ValueError:
        _log.warn("invalid TRIVY_TPU_SECRET_PACK_MB; using default")
        return None
    return max(int(mb * (1 << 20)) // nfa.CHUNK, 1)


def stream_chunk_bytes() -> int:
    """Streaming-mode chunk size (``TRIVY_TPU_SECRET_STREAM_CHUNK_MB``,
    default 4 MiB, floor 64 KiB so the retained window always covers a
    candidate window's halo + one device chunk)."""
    raw = os.environ.get("TRIVY_TPU_SECRET_STREAM_CHUNK_MB", "")
    mb = 4.0
    if raw:
        try:
            mb = float(raw)
        except ValueError:
            _log.warn(
                "invalid TRIVY_TPU_SECRET_STREAM_CHUNK_MB; using default")
    return max(int(mb * (1 << 20)), 64 * 1024)


# whole-file scanning above this size goes through the streaming
# chunked path (the reference warns at 10 MiB and punts; here the
# streaming scan is byte-identical to whole-file)
STREAM_THRESHOLD = 10 * 1024 * 1024

# resolved --cache-dir published by the CLI per invocation (the same
# per-run module-state pattern as secret_analyzer.USE_DEVICE): the
# compiled-NFA cache must honor an explicit cache dir like every other
# cache, and the scanner sits too deep to see `args`. None = fall back
# to TRIVY_TPU_CACHE_DIR / the default.
_CACHE_DIR_OVERRIDE: str | None = None


def set_cache_dir(path: str | None) -> None:
    """Set (or with None, clear) the compiled-NFA cache root for this
    process — called by the CLI with the resolved --cache-dir."""
    global _CACHE_DIR_OVERRIDE
    _CACHE_DIR_OVERRIDE = path

# one-shot per-process hybrid probe verdict: {"device": bool, "reason",
# "device_s", "host_s", "corpus_mb"} once measured; None = not probed
# yet. The probe decides whether hybrid mode's device share is worth
# dispatching at all on this process's card.
_HYBRID_PROBE: dict | None = None
_HYBRID_PROBE_LOCK = make_lock("secret.scanner._HYBRID_PROBE_LOCK")


def reset_hybrid_probe() -> None:
    """Forget the cached hybrid-probe verdict (tests)."""
    global _HYBRID_PROBE
    with _HYBRID_PROBE_LOCK:
        _HYBRID_PROBE = None


def hybrid_probe_state() -> dict | None:
    """The cached hybrid-probe verdict ({"device", "reason",
    "device_s", "host_s", "corpus_mb"}) or None when the probe has not
    run."""
    with _HYBRID_PROBE_LOCK:
        return dict(_HYBRID_PROBE) if _HYBRID_PROBE is not None else None


@dataclass
class CompiledRule:
    rule: Rule
    regex: re.Pattern
    keywords: list[bytes]
    path_rx: re.Pattern | None


@dataclass
class SecretConfig:
    custom_rules: list[Rule] = field(default_factory=list)
    custom_allow_rules: list[AllowRule] = field(default_factory=list)
    enable_builtin_rules: list[str] = field(default_factory=list)
    disable_rules: list[str] = field(default_factory=list)
    disable_allow_rules: list[str] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "SecretConfig":
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        cfg = cls()
        for r in doc.get("rules") or []:
            cfg.custom_rules.append(Rule(
                id=r.get("id", ""), category=r.get("category", "General"),
                title=r.get("title", ""),
                severity=str(r.get("severity", "UNKNOWN")).upper(),
                regex=r.get("regex", ""),
                keywords=r.get("keywords", []) or [],
                secret_group=r.get("secret-group-name", ""),
                path_pattern=r.get("path", ""),
            ))
        for r in doc.get("allow-rules") or []:
            cfg.custom_allow_rules.append(AllowRule(
                id=r.get("id", ""), description=r.get("description", ""),
                regex=r.get("regex", ""), path=r.get("path", ""),
            ))
        cfg.enable_builtin_rules = doc.get("enable-builtin-rules") or []
        cfg.disable_rules = doc.get("disable-rules") or []
        cfg.disable_allow_rules = doc.get("disable-allow-rules") or []
        return cfg


def _new_device_stats() -> dict:
    return {"files": 0, "chunks": 0, "chunk_s": 0.0, "dispatch_s": 0.0,
            "wait_s": 0.0, "verify_s": 0.0, "program_s": 0.0,
            "degraded": 0}


class SecretScanner:
    def __init__(self, config: SecretConfig | None = None, device=None):
        self._device_arg = device
        self._device = None  # resolved at the first device use
        self._tiers = None
        self._kw_state = None  # lazy (matcher, rule->kw-index lists, ids)
        self._host_tiers = None  # lazy host-floor / streaming partition
        self._matcher = None  # one AnchorMatcher per scanner (device
        # arrays upload once, not per scan_files call)
        self._sched = None  # lazy secret-lane MatchScheduler
        self._sched_lock = make_lock("secret.scanner._sched_lock")
        self.program_source = None  # "cache" / "compiled" once tiered
        # where the device path's time goes, summed over its scans:
        # chunking, copy + launch, waiting for the words, host regex,
        # and the screen program's load from the compiled-NFA cache (or
        # its compile and save on a miss)
        self.device_stats = _new_device_stats()
        self._stats_lock = threading.Lock()
        # per thread: the open stats scopes, and whether the hybrid
        # probe runs (its device scans are not the caller's)
        self._tls = threading.local()
        # the lazy builds (_ensure_tiers, _ensure_kw_matcher,
        # _ensure_host_tiers) run once, whichever thread comes first
        self._build_lock = threading.RLock()
        config = config or SecretConfig()
        rules = list(BUILTIN_RULES)
        if config.enable_builtin_rules:
            enabled = set(config.enable_builtin_rules)
            rules = [r for r in rules if r.id in enabled]
        rules += config.custom_rules
        disabled = set(config.disable_rules)
        rules = [r for r in rules if r.id not in disabled]

        self.rules: list[CompiledRule] = []
        for r in rules:
            try:
                self.rules.append(CompiledRule(
                    rule=r,
                    regex=re.compile(r.regex.encode()),
                    keywords=[k.lower().encode() for k in r.keywords],
                    path_rx=re.compile(re.escape(r.path_pattern).replace(r"\*", ".*") + "$")
                    if r.path_pattern else None,
                ))
            except re.error as e:
                _log.warn("invalid secret rule regex", rule=r.id, err=str(e))

        allow = list(BUILTIN_ALLOW_RULES) + config.custom_allow_rules
        disabled_allow = set(config.disable_allow_rules)
        self.allow_rules = []
        for a in allow:
            if a.id in disabled_allow:
                continue
            self.allow_rules.append((
                a,
                re.compile(a.path) if a.path else None,
                re.compile(a.regex.encode()) if a.regex else None,
            ))
        # config-derived sets hoisted out of the per-file hot loop: a
        # precompiled suffix tuple for one C-level endswith, the
        # path-only allow rules split from the value rules, and a
        # bounded per-path verdict memo
        self._skip_suffixes = tuple(SKIP_EXTENSIONS)
        self._path_only_allow = [
            path_rx for _a, path_rx, content_rx in self.allow_rules
            if path_rx is not None and content_rx is None]
        self._value_allow = [
            (path_rx, content_rx)
            for _a, path_rx, content_rx in self.allow_rules
            if content_rx is not None]
        self._path_memo: dict[str, bool] = {}

    @property
    def device(self):
        """The torch device of the screen: ``cuda:0`` unless the scanner
        was built with ``device="cpu"``; raises without a card."""
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    # ----------------------------------------------------------- stats

    def _stat(self, key: str, delta) -> None:
        """Add `delta` to `device_stats[key]` and to every stats scope
        this thread has open; nothing while the hybrid probe runs."""
        if getattr(self._tls, "quiet", False):
            return
        with self._stats_lock:
            self.device_stats[key] += delta
        for scope in getattr(self._tls, "scopes", ()):
            scope[key] += delta

    @contextlib.contextmanager
    def stats_scope(self):
        """-> a `device_stats`-shaped dict that receives what this
        thread adds to `device_stats` inside the block (other threads'
        scans sharing the scanner are not counted)."""
        scope = _new_device_stats()
        scopes = self._tls.__dict__.setdefault("scopes", [])
        scopes.append(scope)
        try:
            yield scope
        finally:
            scopes.remove(scope)

    # ------------------------------------------------------------ scan

    _PATH_MEMO_MAX = 65536

    def skip_file(self, path: str) -> bool:
        return path.lower().endswith(self._skip_suffixes)

    def path_allowed(self, path: str) -> bool:
        """True if a path-only allow rule excludes this whole path.
        Memoized per path (bounded)."""
        hit = self._path_memo.get(path)
        if hit is not None:
            return hit
        out = any(rx.match(path) for rx in self._path_only_allow)
        if len(self._path_memo) >= self._PATH_MEMO_MAX:
            self._path_memo.clear()
        self._path_memo[path] = out
        return out

    def _allowed(self, path: str, secret: bytes) -> bool:
        """Value allow rules; a rule with BOTH path and regex only applies
        where its path matches."""
        for path_rx, content_rx in self._value_allow:
            if path_rx is not None and not path_rx.match(path):
                continue
            if content_rx.match(secret):
                return True
        return False

    # ------------------------------------------------------------ batch

    MAX_WINDOW_WIDTH = 4096  # regexes wider than this scan whole-file

    def _ruleset_digest(self) -> str:
        """Content digest of everything the compiled NFA program depends
        on: the exact rule list (order matters — anchor rows index into
        it) plus the kernel/anchor constants whose change would make a
        cached program stale."""
        doc = [
            [cr.rule.id, cr.rule.regex,
             [k.decode("latin1") for k in cr.keywords],
             cr.rule.path_pattern]
            for cr in self.rules
        ]
        doc.append(["v", nfa.KERNEL_VERSION, nfa.K_ANCHOR,
                    nfa.MAX_CLASS_WORDS, nfa.CHUNK, self.MAX_WINDOW_WIDTH])
        return hashlib.sha256(
            json.dumps(doc, separators=(",", ":")).encode()
        ).hexdigest()[:32]

    @staticmethod
    def _nfa_cache_dir() -> str:
        if _CACHE_DIR_OVERRIDE:
            return _CACHE_DIR_OVERRIDE
        return os.environ.get(
            "TRIVY_TPU_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "trivy-tpu"))

    def _compile_program(self) -> dict:
        """Compile the ruleset into the NFA program: anchor class rows +
        per-rule tier assignments (no bank yet — the bank choice depends
        on the device)."""
        # (rule index, window pad before, pad after, tier kind)
        anchors: list[tuple[int, int, int, str]] = []
        rows: list[list[np.ndarray]] = []
        file_idx: list[int] = []
        always_idx: list[int] = []
        for i, cr in enumerate(self.rules):
            pattern = cr.rule.regex
            seq = nfa.compile_class_sequence(pattern)
            if seq is not None:
                off, classes = nfa.choose_anchor(seq)
                rows.append(classes)
                anchors.append((i, off, len(seq) - off, "seq"))
                continue
            width = nfa.regex_width(pattern)
            lit = nfa.required_literal(pattern)
            if (lit is not None and width is not None
                    and width[1] < self.MAX_WINDOW_WIDTH
                    and not nfa.has_anchor(pattern)):
                rows.append(nfa.literal_anchor(lit))
                anchors.append((i, width[1], width[1], "lit"))
                continue
            (file_idx if cr.keywords else always_idx).append(i)

        # keyword rows (deduped across rules) appended after rule anchors
        kw_order: list[bytes] = []
        seen: set[bytes] = set()
        for cr in self.rules:
            for k in cr.keywords:
                if k not in seen:
                    seen.add(k)
                    kw_order.append(k)
                    rows.append(nfa.literal_anchor(k))
        return {"rows": rows, "anchors": anchors, "kw_order": kw_order,
                "file_idx": file_idx, "always_idx": always_idx}

    def _load_program(self, digest: str) -> dict | None:
        """Compiled-NFA program from the persistent compiled-artifact
        cache (tensorize/cache.load_nfa), or None on a miss — warm
        starts skip the per-rule regex analysis entirely."""
        from trivy_tpu_torch.tensorize import cache as compile_cache

        hit = compile_cache.load_nfa(self._nfa_cache_dir(), digest)
        if hit is None:
            return None
        arrays, meta = hit
        try:
            if meta.get("n_rules") != len(self.rules):
                raise ValueError("rule count mismatch")
            rows = nfa.unpack_anchor_rows(arrays["row_bits"],
                                          arrays["row_lens"])
            kinds = ("seq", "lit")
            anchors = [
                (int(i), int(lo), int(hi), kinds[int(k)])
                for i, lo, hi, k in zip(
                    arrays["a_idx"].tolist(), arrays["a_lo"].tolist(),
                    arrays["a_hi"].tolist(), arrays["a_kind"].tolist())
            ]
            return {
                "rows": rows,
                "anchors": anchors,
                "kw_order": [k.encode("latin1")
                             for k in meta["kw_order"]],
                "file_idx": [int(i) for i in arrays["file_idx"].tolist()],
                "always_idx": [int(i)
                               for i in arrays["always_idx"].tolist()],
            }
        except Exception as exc:  # defensive: treat as miss, recompile
            _log.warn("compiled secret-NFA entry unusable; recompiling",
                      err=str(exc))
            return None

    def _save_program(self, digest: str, program: dict) -> None:
        from trivy_tpu_torch.tensorize import cache as compile_cache

        bits, lens = nfa.pack_anchor_rows(program["rows"])
        anchors = program["anchors"]
        kind_id = {"seq": 0, "lit": 1}
        arrays = {
            "row_bits": bits,
            "row_lens": lens,
            "a_idx": np.array([a[0] for a in anchors], dtype=np.int32),
            "a_lo": np.array([a[1] for a in anchors], dtype=np.int32),
            "a_hi": np.array([a[2] for a in anchors], dtype=np.int32),
            "a_kind": np.array([kind_id[a[3]] for a in anchors],
                               dtype=np.uint8),
            "file_idx": np.array(program["file_idx"], dtype=np.int32),
            "always_idx": np.array(program["always_idx"],
                                   dtype=np.int32),
        }
        meta = {
            "n_rules": len(self.rules),
            "kw_order": [k.decode("latin1")
                         for k in program["kw_order"]],
        }
        compile_cache.save_nfa(self._nfa_cache_dir(), digest, arrays,
                               meta)

    def _ensure_tiers(self) -> None:
        """Partition rules into device tiers:

        - seq: regex compiles EXACTLY to a fixed-length class sequence
          -> the least-likely K consecutive classes become the device
          anchor; host regex only inside hit-chunk windows
        - lit: a required literal factor exists and the regex has bounded
          width -> the literal becomes a case-closed anchor
        - file: keyword-prefiltered whole-file host regex (unbounded
          patterns, e.g. PEM blocks)
        - always: keyword-less whole-file host regex

        Every rule keyword also becomes an anchor row, so the reference's
        keyword-prefilter semantics (scanner.go:174-186) read straight
        off the same device bitmap — no host lowercasing pass. The bank
        and its matcher live on the scanner's device.

        The compiled program (anchor rows + tier table) persists in the
        compiled-artifact cache keyed by ruleset digest, so warm starts
        skip the per-rule regex analysis; `program_source` records
        which ("cache" or "compiled")."""
        if self._tiers is not None:
            return
        with self._build_lock:
            if self._tiers is None:
                self._build_tiers()

    def _build_tiers(self) -> None:
        t0 = time.perf_counter()
        digest = self._ruleset_digest()
        program = self._load_program(digest)
        self.program_source = "cache"
        if program is None:
            program = self._compile_program()
            self._save_program(digest, program)
            self.program_source = "compiled"
        self._stat("program_s", time.perf_counter() - t0)
        rows = program["rows"]
        anchor_rules = [(self.rules[i], lo, hi, kind)
                        for i, lo, hi, kind in program["anchors"]]
        file_rules = [self.rules[i] for i in program["file_idx"]]
        always_rules = [self.rules[i] for i in program["always_idx"]]
        kw_ids = {k: len(anchor_rules) + j
                  for j, k in enumerate(program["kw_order"])}

        bank = nfa.make_anchor_bank(rows, self.device) if rows else None
        # keywords whose device bit is EXACT (not a truncated/overflowed
        # superset): a set bit alone proves presence; others need a host
        # substring confirm to preserve reference prefilter semantics
        kw_exact = {
            k: len(k) <= nfa.K_ANCHOR
            and (bank is None or i not in bank.overflow_rows)
            for k, i in kw_ids.items()
        }
        if bank is not None:
            self._matcher = nfa.AnchorMatcher(
                bank, batch_chunks=_pack_chunks(), device=self.device)
        self._tiers = {
            "bank": bank,
            "anchor_rules": anchor_rules,
            "kw_ids": kw_ids,
            "kw_exact": kw_exact,
            "file_rules": file_rules,
            "always_rules": always_rules,
        }
        _log.debug(
            "secret rule tiers",
            source=self.program_source,
            compile_ms=round((time.perf_counter() - t0) * 1e3, 1),
            seq=sum(1 for a in anchor_rules if a[3] == "seq"),
            lit=sum(1 for a in anchor_rules if a[3] == "lit"),
            file=len(file_rules), always=len(always_rules),
            keywords=len(kw_ids))

    def scan_files(self, batch: list[tuple[str, bytes]],
                   use_device: bool | Literal["hybrid"] = True
                   ) -> list[Secret]:
        """Batched scan: device NFA + literal-window passes over all
        files at once, host regex only inside candidate windows; rules
        that can't window-verify keep the whole-file host path.

        `use_device` is tri-state:

        - ``False``    pure-host path (native AC + whole-file regex);
        - ``True``     device tiers (NFA + literal windows), host
                       regex only inside candidate windows;
        - ``"hybrid"`` byte-split corpus: a device share dispatched
                       async up front, the host AC path scanning the
                       rest concurrently (host-only when the scanner's
                       device is the CPU, or when the one-shot probe
                       measures the device share slower than it repays).

        A device failure raises. Any other string is a config error
        and raises ValueError.

        Files over STREAM_THRESHOLD route through the streaming chunked
        path (scan_stream) — byte-identical findings, bounded window
        memory — instead of blowing up the packed super-buffers."""
        if isinstance(use_device, str) and use_device != "hybrid":
            raise ValueError(
                f"use_device={use_device!r}: expected True, False or "
                "'hybrid'")
        if usage.ambient() is not None:
            # metered once at the batch entry point — the streaming and
            # hybrid paths all funnel through here, so deeper accruals
            # would double-count
            usage.add("secret_mb",
                      sum(len(c) for _p, c in batch) / 1e6)
        eligible = [
            (i, path, content) for i, (path, content) in enumerate(batch)
            if not self.skip_file(path) and not self.path_allowed(path)
            and b"\x00" not in content[:8000]
        ]
        if not eligible:
            return []
        big = [e for e in eligible if len(e[2]) > STREAM_THRESHOLD]
        if not big:
            return self._scan_batch(eligible, use_device)
        small = [e for e in eligible if len(e[2]) <= STREAM_THRESHOLD]
        out = self._scan_batch(small, use_device) if small else []
        for _i, path, content in big:
            s = self.scan_stream(path, content, use_device=use_device)
            if s is not None:
                out.append(s)
        by_path = {s.file_path: s for s in out}
        return [by_path[p] for (_i, p, _c) in eligible if p in by_path]

    def _scan_batch(self, eligible, use_device) -> list[Secret]:
        """Whole-file batch paths (host / device tiers / hybrid split)
        for the sub-threshold files of one scan_files call."""
        if not eligible:
            return []
        if not use_device:
            return self._scan_files_host(eligible)
        self._ensure_tiers()
        if use_device == "hybrid":
            if self._accel_backend() and self._hybrid_device_ok():
                return self._scan_files_hybrid(eligible)
            # no card (the "device" share would run the screen's plain
            # version on the CPU, slower than the native-AC host path),
            # or the one-shot probe measured the device screen slower
            # than its share repays: the host scans it all
            obs_metrics.SECRET_DEVICE_SHARE.set(0.0)
            return self._scan_files_host(eligible)
        try:
            return self._scan_files_device(eligible)
        except DEGRADE_ON as exc:
            self._degrade("device secret screen", exc)
            return self._scan_files_host(eligible)

    def _degrade(self, what: str, exc: Exception) -> None:
        """One scan (or one streamed file) leaves the device for the
        host scanner: logged and counted in device_stats["degraded"]."""
        _log.warn(f"{what} unavailable; scanning on the host", err=str(exc))
        self._stat("degraded", 1)
        obs_metrics.DEGRADED_TOTAL.inc(component="secret")

    # device share of a hybrid scan: this fraction of the bytes is
    # dispatched to the device up front; the host scans the rest while
    # the card computes (dispatch-first, single thread — see
    # _scan_files_hybrid)
    HYBRID_DEVICE_SHARE = 0.3

    def _accel_backend(self) -> bool:
        """True when the screen runs on a card."""
        return self.device.type == "cuda"

    # ------------------------------------------------- screen dispatch

    def _screen_fire(self) -> None:
        """``secret.device`` fault site, fired once per anchor-screen
        submission: drop/error make the screen unavailable (the caller
        degrades to the host scanner, zero finding diff), delay stalls
        the dispatch, device-lost raises faults.DeviceLost."""
        for rule in faults.fire("secret.device"):
            if rule.action == "delay":
                time.sleep(rule.param if rule.param is not None
                           else 0.002)
            elif rule.action in ("drop", "error"):
                raise ScreenUnavailable(
                    f"injected secret.device {rule.action}")
            elif rule.action == "device-lost":
                raise faults.DeviceLost(
                    "injected device loss at secret.device")

    @contextlib.contextmanager
    def _direct_dispatch(self):
        """This thread's screens bypass the secret lane: the hybrid
        probe times the screen itself, not a wait behind the lane's
        coalescing window and the other threads of a concurrent scan."""
        self._tls.direct = True
        try:
            yield
        finally:
            self._tls.direct = False

    def _screen_scheduler(self):
        """Lazy per-scanner secret-lane MatchScheduler: the anchor
        screens of concurrent scans (walk lanes, embedded concurrent
        scans) coalesce into shared super-buffer dispatches — the same
        micro-batch machinery the vuln-match path rides, with chunk
        rows instead of package-query rows. None when
        TRIVY_TPU_SCHED=0 (direct per-scan dispatch)."""
        from trivy_tpu_torch import sched as sched_mod

        if not sched_mod.enabled():
            return None
        with self._sched_lock:
            if self._sched is None:
                pack = _pack_chunks() or self._matcher.batch_chunks
                self._sched = sched_mod.MatchScheduler(
                    lambda: _ScreenEngine(self),
                    max_rows=pack,
                    chunk_rows=max(pack // 8, 16),
                    lane="secret")
            return self._sched

    def close(self) -> None:
        """Stop the secret-lane scheduler thread (tests/embedding)."""
        with self._sched_lock:
            if self._sched is not None:
                self._sched.close()
                self._sched = None

    def _screen_submit(self, chunks: np.ndarray):
        """Enqueue the anchor screen for one packed super-buffer
        without blocking -> zero-arg collect(). DISPATCH-FIRST: the
        chunks are handed to the shared secret-lane scheduler (or
        enqueued directly as async device batches) so the card computes
        while the caller does host work; collect() blocks only on
        whatever is still in flight."""
        self._screen_fire()
        matcher = self._matcher
        if len(chunks) == 0:
            n = self._tiers["bank"].n
            return lambda: np.zeros((0, n), dtype=bool)
        t0 = time.perf_counter()
        sched = None if getattr(self._tls, "direct", False) \
            else self._screen_scheduler()
        if sched is not None:
            p = sched.submit_async(list(chunks))

            def wait():
                return np.stack(sched.collect(p))
        else:
            pend = matcher.dispatch_chunks(chunks)

            def wait():
                return matcher.collect_chunks(pend)
        self._stat("dispatch_s", time.perf_counter() - t0)
        self._stat("chunks", len(chunks))

        def collect():
            t1 = time.perf_counter()
            hits = wait()
            self._stat("wait_s", time.perf_counter() - t1)
            return hits

        return collect

    def _effective_device_share(self) -> float:
        """The byte fraction the hybrid split actually hands the device
        (env override honored) — the probe must judge the SAME split
        the scan will run."""
        try:
            share = float(os.environ.get(
                "TRIVY_TPU_SECRET_DEVICE_SHARE",
                self.HYBRID_DEVICE_SHARE))
        except ValueError:
            _log.warn("invalid TRIVY_TPU_SECRET_DEVICE_SHARE; using default")
            share = self.HYBRID_DEVICE_SHARE
        return max(min(share, 1.0), 0.0)

    def _hybrid_device_ok(self) -> bool:
        """Should hybrid mode dispatch its device share at all? One-shot
        per-process probe: times the device anchor screen against the
        native host path on a small synthetic corpus and keeps the host
        alone when the device is measurably slower. The verdict is
        cached for the process. A screen the secret.device ladder
        reports unavailable keeps the host alone; any other device
        failure raises. TRIVY_TPU_SECRET_PROBE=0 skips the probe (always
        keep the device share)."""
        if os.environ.get("TRIVY_TPU_SECRET_PROBE", "1") == "0":
            return True
        global _HYBRID_PROBE
        with _HYBRID_PROBE_LOCK:
            if _HYBRID_PROBE is None:
                _HYBRID_PROBE = self._run_hybrid_probe()
            return _HYBRID_PROBE["device"]

    # extra margin on the probe's hybrid-helps bar ("measurably
    # slower" = beyond it): the share-weighted device time must beat
    # the host's full-scan time by at least this factor
    HYBRID_PROBE_SLACK = 1.25

    def _run_hybrid_probe(self) -> dict:
        # deterministic kernel-tree-shaped probe corpus, ~500 KB so
        # per-batch dispatch overhead does not drown throughput
        line = (b"static int cfg_%d(struct s *p) { return probe(p, %d); }"
                b"\n/* tokens */\n")
        corpus = [(i, f"probe/f{i}.c", b"".join(line % (j, i)
                                                for j in range(300)))
                  for i in range(24)]
        corpus_mb = sum(len(c) for (_i, _p, c) in corpus) / 1e6
        self._ensure_tiers()  # probe may run before any batch scan
        # the probe is not the caller's scan: its device scans add
        # nothing to device_stats, and dispatch directly (through the
        # lane, a probe inside a concurrent image walk timed the other
        # walk lanes' turns)
        self._tls.quiet = True
        try:
            with self._direct_dispatch():
                self._scan_files_device(corpus)  # warm (kernel build)
                t0 = time.perf_counter()
                self._scan_files_device(corpus)
                dev_s = time.perf_counter() - t0
        except DEGRADE_ON as exc:
            _log.debug("secret hybrid probe: device screen unavailable; "
                       "hybrid keeps the host alone", err=str(exc))
            obs_metrics.SECRET_PROBE_DEVICE.set(0)
            return {"device": False, "reason": f"unavailable: {exc}",
                    "device_s": None, "host_s": None,
                    "corpus_mb": corpus_mb}
        finally:
            self._tls.quiet = False
        t0 = time.perf_counter()
        self._scan_files_host(corpus)
        host_s = time.perf_counter() - t0
        # the hybrid split hands the device only its effective share of
        # the bytes while the host scans the rest concurrently, so the
        # device share helps wall-clock when share x dev_s stays within
        # the host's full-scan time (see _scan_files_hybrid); the slack
        # TIGHTENS the bar (borderline devices keep the host alone)
        device = dev_s * self._effective_device_share() \
            * self.HYBRID_PROBE_SLACK <= host_s
        # the decision + both measured throughputs live on /metrics
        # (and /readyz via hybrid_probe_state) — not just a debug log
        obs_metrics.SECRET_PROBE_DEVICE.set(1 if device else 0)
        if dev_s > 0:
            obs_metrics.SECRET_PROBE_MBPS.set(corpus_mb / dev_s,
                                              path="device")
        if host_s > 0:
            obs_metrics.SECRET_PROBE_MBPS.set(corpus_mb / host_s,
                                              path="host")
        _log.debug(
            "secret hybrid probe",
            device_ms=round(dev_s * 1e3, 2), host_ms=round(host_s * 1e3, 2),
            choice="hybrid" if device else "host",
            reason="device share pays for itself" if device
            else "device measurably slower than its share repays")
        return {"device": device, "reason": "probe", "device_s": dev_s,
                "host_s": host_s, "corpus_mb": corpus_mb}

    def _scan_files_hybrid(self, eligible) -> list[Secret]:
        """Split the corpus by bytes between the device screen and the
        host AC path, DISPATCH-FIRST: every device batch is enqueued
        (async, non-blocking) before the host share is scanned, so the
        card computes and its results stream back while the host CPU
        chews its own share — no threads, no GIL contention. A screen the
        secret.device ladder reports unavailable leaves the device share
        to the host; any other device failure raises."""
        share = self._effective_device_share()
        obs_metrics.SECRET_DEVICE_SHARE.set(share)
        total = sum(len(c) for (_i, _p, c) in eligible) or 1
        budget = total * share
        dev_part: list = []
        host_part: list = []
        acc = 0
        for item in eligible:
            if acc < budget:
                dev_part.append(item)
                acc += len(item[2])
            else:
                host_part.append(item)
        try:
            pre = self._dispatch_device(dev_part)
        except DEGRADE_ON as exc:
            self._degrade("hybrid device dispatch", exc)
            obs_metrics.SECRET_DEVICE_SHARE.set(0.0)
            pre = None
        host_res = self._scan_files_host(host_part)
        dev_res = None
        if pre is not None:
            try:
                dev_res = self._scan_files_device(dev_part, prefetched=pre)
            except DEGRADE_ON as exc:
                self._degrade("hybrid device collect", exc)
                obs_metrics.SECRET_DEVICE_SHARE.set(0.0)
        if dev_res is None:
            # nothing to screen (no anchor rows, no device share), or
            # the screen was unavailable
            dev_res = self._scan_files_host(dev_part)
        by_path = {s.file_path: s for part in (dev_res, host_res)
                   for s in part}
        return [by_path[p] for (_i, p, _c) in eligible if p in by_path]

    def _dispatch_device(self, eligible):
        """Chunk + enqueue the device screen for a file set without
        blocking. -> (collect, segments) for _scan_files_device."""
        t = self._tiers
        if t["bank"] is None or not eligible:
            return None
        t0 = time.perf_counter()
        chunks, segments = nfa.chunk_files_packed(
            [c for (_i, _p, c) in eligible])
        self._stat("chunk_s", time.perf_counter() - t0)
        return self._screen_submit(chunks), segments

    def _scan_files_host(self, eligible) -> list[Secret]:
        out = []
        for _i, path, content in eligible:
            secret = self.scan_file(path, content)
            if secret is not None:
                out.append(secret)
        return out

    # ----------------------------------------------- keyword prefilter

    def _ensure_kw_matcher(self):
        """One-pass multi-keyword matcher for the host prefilter
        (replacing the reference's rules x strings.Contains loop,
        scanner.go:174-186): C++ Aho-Corasick when the native library
        builds, None otherwise (callers use bytes.find on the host).
        -> (matcher | None, per-rule keyword-index lists,
        keyword -> index map)."""
        if self._kw_state is not None:
            return self._kw_state
        with self._build_lock:
            if self._kw_state is None:
                self._kw_state = self._build_kw_matcher()
        return self._kw_state

    def _build_kw_matcher(self):
        kw_ids: dict[bytes, int] = {}
        rule_kws: list[list[int]] = []
        for cr in self.rules:
            rule_kws.append([kw_ids.setdefault(k, len(kw_ids))
                             for k in cr.keywords])
        matcher = None
        if kw_ids:
            try:
                from trivy_tpu_torch.native.ac import NativeMatcher

                matcher = NativeMatcher(list(kw_ids))
            except (RuntimeError, OSError):
                matcher = None
        return matcher, rule_kws, kw_ids

    def _kw_present_set(self, content: bytes) -> set[bytes]:
        """All configured rule keywords occurring in `content`, via one
        case-folded native-AC pass over the raw bytes (no lowercase
        copy); substring-on-lowered without the native lib."""
        matcher, _rule_kws, kw_index = self._ensure_kw_matcher()
        if matcher is None:
            low = content.lower()
            return {k for k in kw_index if k in low}
        hits = matcher.scan(content)
        return {k for k, i in kw_index.items() if hits[i]}

    # ------------------------------------------------------ host floor

    # prefix-literal windows cap: rules wider than this verify whole-
    # file on the host (windowing would barely trim the scan anyway)
    HOSTLIT_MAX_WIDTH = 65536

    def _ensure_host_tiers(self) -> dict:
        """Host-floor + streaming partition, computed once per ruleset:

        - ``rule_lit``: rules whose regex starts with a >=3-byte
          literal, has bounded width and no position assertions — the
          host path runs their regex only inside ``[occurrence,
          occurrence + max_width]`` windows found by one case-folded
          native-AC pass (the host analogue of the device lit tier;
          byte-identical match sequence).
        - ``bounded`` / ``oversized``: the streaming-mode split — a
          bounded rule's matches fit one halo window, an oversized
          (unbounded width / assertion-bearing) rule keeps whole-file
          semantics via the streaming full pass."""
        if self._host_tiers is not None:
            return self._host_tiers
        with self._build_lock:
            if self._host_tiers is None:
                self._build_host_tiers()
        return self._host_tiers

    def _build_host_tiers(self) -> None:
        lit_ids: dict[bytes, int] = {}
        rule_lit: dict[int, tuple[int, int]] = {}
        bounded: list[int] = []
        oversized: list[int] = []
        for i, cr in enumerate(self.rules):
            w = nfa.regex_width(cr.rule.regex)
            anchored = nfa.has_anchor(cr.rule.regex)
            if (w is not None and w[1] <= self.MAX_WINDOW_WIDTH
                    and not anchored):
                bounded.append(i)
            else:
                oversized.append(i)
            if anchored or w is None or w[1] >= self.HOSTLIT_MAX_WIDTH:
                continue
            lit = nfa.prefix_literal(cr.rule.regex)
            if lit is not None:
                lid = lit_ids.setdefault(lit.lower(), len(lit_ids))
                rule_lit[i] = (lid, int(w[1]))
        matcher = None
        if rule_lit:
            try:
                from trivy_tpu_torch.native.ac import NativeMatcher

                matcher = NativeMatcher(list(lit_ids))
            except (RuntimeError, OSError):
                matcher = None
        self._rule_pos = {id(cr): i for i, cr in enumerate(self.rules)}
        self._host_tiers = {
            "bounded": set(bounded),
            "oversized": set(oversized),
            "rule_lit": rule_lit,
            "lit_lens": [len(lit) for lit in lit_ids],
            "lit_matcher": matcher,
        }

    def _host_matches(self, cr: CompiledRule, content: bytes,
                      pos_cache: dict):
        """Yield ``cr.regex`` matches over `content` exactly as
        ``finditer(content)`` would — but when the rule has a prefix
        literal, the regex runs only inside merged ``[occurrence,
        occurrence + max_width]`` windows from one shared case-folded
        AC position pass.  Sound and exact: every match STARTS at a
        (case-folded superset) occurrence, and the resume cursor
        carries finditer's non-overlap consumption across windows."""
        ht = self._ensure_host_tiers()
        info = ht["rule_lit"].get(self._rule_pos[id(cr)])
        matcher = ht["lit_matcher"]
        if info is None or matcher is None:
            yield from cr.regex.finditer(content)
            return
        if "pos" not in pos_cache:
            hit = matcher.scan_positions(content)
            if hit is None:
                # more occurrences than the cap: positions unknowable,
                # whole-buffer scans for every hostlit rule of this file
                pos_cache["pos"] = None
            else:
                ids, ends = hit
                pos_cache["pos"] = (ids, ends)
        if pos_cache["pos"] is None:
            yield from cr.regex.finditer(content)
            return
        ids, ends = pos_cache["pos"]
        lit_id, width_hi = info
        starts = ends[ids == lit_id] - (ht["lit_lens"][lit_id] - 1)
        if len(starts) == 0:
            return  # no occurrence -> no match can start anywhere
        resume = 0
        lo = int(starts[0])
        hi = lo + width_hi + 1
        for s in starts[1:].tolist():
            if s <= hi:
                hi = s + width_hi + 1
                continue
            p = max(lo, resume)
            if p < hi:
                for m in cr.regex.finditer(content, p, min(hi,
                                                           len(content))):
                    yield m
                    resume = m.end()
            lo, hi = s, s + width_hi + 1
        p = max(lo, resume)
        if p < hi:
            for m in cr.regex.finditer(content, p, min(hi, len(content))):
                yield m

    def _scan_files_device(self, eligible, prefetched=None) -> list[Secret]:
        t = self._tiers
        self._stat("files", len(eligible))
        contents = [c for (_i, _p, c) in eligible]
        anchor_rules = t["anchor_rules"]
        n_a = len(anchor_rules)
        kw_ids = t["kw_ids"]
        nf = len(contents)
        windows: list[dict[int, list]] = [dict() for _ in range(nf)]
        kw_present_f = np.zeros((nf, len(kw_ids)), dtype=bool)
        # a keyword bit from a chunk SHARED by several files proves
        # presence only at chunk resolution — those files must confirm
        # on host even for exact (short, unoverflowed) keywords
        kw_solo_f = np.zeros((nf, len(kw_ids)), dtype=bool)
        if t["bank"] is not None:
            if prefetched is not None:
                collect, segments = prefetched
            else:
                collect, segments = self._dispatch_device(eligible)
            # device_wait attribution lane: the dispatch-first split
            # blocks here, after the host share has been scanned
            with tracing.span("secret.screen", files=nf):
                hits = collect()
            t0 = time.perf_counter()
            # flatten segments once; keyword rows hit densely (common
            # words fire in nearly every chunk), so their per-file OR is
            # a sorted reduceat, not a Python loop — only the sparse
            # anchor-rule hits take the window-building loop below
            seg_chunk, seg_file, seg_solo = (
                np.array([c for c, segs in enumerate(segments)
                          for _ in segs], dtype=np.int64),
                np.array([s[0] for segs in segments for s in segs],
                         dtype=np.int64),
                np.array([len(segs) == 1 for segs in segments
                          for _ in segs], dtype=bool),
            )
            if len(seg_chunk) and len(kw_ids):
                order = np.argsort(seg_file, kind="stable")
                sf = seg_file[order]
                kw_rows = hits[seg_chunk[order], n_a:]
                bounds = np.searchsorted(sf, np.arange(nf + 1))
                # reduce only over files that HAVE segments: their starts
                # are strictly increasing and each span runs to the next
                # occupied file's start, so every file's reduction covers
                # exactly its own segments
                occ = np.nonzero(bounds[:-1] < bounds[1:])[0]
                if len(occ):
                    kw_present_f[occ] = np.maximum.reduceat(
                        kw_rows, bounds[:-1][occ], axis=0)
                    kw_solo_f[occ] = np.maximum.reduceat(
                        kw_rows & seg_solo[order][:, None],
                        bounds[:-1][occ], axis=0)
            ci, ri = np.nonzero(hits[:, :n_a])
            for c, r in zip(ci.tolist(), ri.tolist()):
                for fi, file_off, _chunk_off, seg_len in segments[c]:
                    cr, pad_lo, pad_hi, _kind = anchor_rules[r]
                    lo = max(file_off - pad_lo, 0)
                    hi = min(file_off + seg_len + pad_hi,
                             len(contents[fi]))
                    windows[fi].setdefault(r, []).append((lo, hi))
        else:
            t0 = time.perf_counter()

        kw_exact = t["kw_exact"]
        out = []
        for fi, (_orig, path, content) in enumerate(eligible):
            findings: list[SecretFinding] = []
            spans: set[tuple[str, int, int]] = set()
            kw_set = None

            def kw_present(cr) -> bool:
                # reference semantics: a rule with keywords only runs when
                # one occurs in the file (scanner.go:174-186). The device
                # bitmap is exact for short keywords; truncated/overflowed
                # ones are a superset, so a set bit for those is confirmed
                # on the host — via ONE case-folded native-AC pass over
                # the raw bytes. Absent bits need no host work at all.
                nonlocal kw_set
                if not cr.keywords:
                    return True
                for k in cr.keywords:
                    if not kw_present_f[fi, kw_ids[k] - n_a]:
                        continue
                    if kw_exact[k] and kw_solo_f[fi, kw_ids[k] - n_a]:
                        return True
                    if kw_set is None:
                        kw_set = self._kw_present_set(content)
                    if k in kw_set:
                        return True
                return False

            # anchored rules: host regex inside hit-chunk windows
            for r, wins in sorted(windows[fi].items()):
                cr = anchor_rules[r][0]
                if cr.path_rx is not None and not cr.path_rx.match(path):
                    continue
                if not kw_present(cr):
                    continue
                self._verify_windows(cr, path, content,
                                     nfa.merge_windows(wins), findings,
                                     spans)
            # keyword-prefiltered whole-file rules
            for cr in t["file_rules"]:
                if not kw_present(cr):
                    continue
                self._verify_windows(cr, path, content,
                                     [(0, len(content))], findings, spans)
            # keyword-less whole-file rules
            for cr in t["always_rules"]:
                self._verify_windows(cr, path, content,
                                     [(0, len(content))], findings, spans)

            if findings:
                findings.sort(key=lambda f: (f.start_line, f.rule_id))
                out.append(Secret(file_path=path, findings=findings))
        self._stat("verify_s", time.perf_counter() - t0)
        return out

    def _verify_windows(self, cr: CompiledRule, path: str, content: bytes,
                        wins, findings, spans) -> None:
        """Run the rule's real regex inside candidate windows; dedupe by
        (rule, span) since windows may overlap across chunks."""
        if cr.path_rx is not None and not cr.path_rx.match(path):
            return
        for lo, hi in wins:
            for m in cr.regex.finditer(content, lo, hi):
                secret_bytes, start, end = self._secret_span(cr, m)
                if secret_bytes is None:
                    continue
                key = (cr.rule.id, start, end)
                if key in spans:
                    continue
                spans.add(key)
                if self._allowed(path, secret_bytes):
                    continue
                findings.append(self._finding(cr, content, start, end))

    def candidate_rules(self, content_lower: bytes) -> list[CompiledRule]:
        """Keyword prefilter (scanner.go:174-186): a rule runs only if one
        of its keywords occurs; keyword-less rules always run."""
        out = []
        for cr in self.rules:
            if not cr.keywords or any(k in content_lower for k in cr.keywords):
                out.append(cr)
        return out

    def _candidate_rules_fast(self, content: bytes) -> list[CompiledRule]:
        """candidate_rules via one case-folded Aho-Corasick pass over the
        raw bytes (no host lowercase copy, no per-keyword substring
        scans); byte-for-byte the same rule set as candidate_rules."""
        matcher, rule_kws, _kw_index = self._ensure_kw_matcher()
        if matcher is None:
            return self.candidate_rules(content.lower())
        hits = matcher.scan(content)
        return [cr for cr, kws in zip(self.rules, rule_kws)
                if not kws or any(hits[i] for i in kws)]

    def scan_stream(self, path: str, source,
                    use_device: bool | Literal["hybrid"] = True
                    ) -> Secret | None:
        """Streaming chunked scan for files over STREAM_THRESHOLD
        (secret/stream.py): overlapping halo windows sized by
        MAX_WINDOW_WIDTH, findings byte-identical to scan_file on the
        full content.  `source` is bytes or a seekable binary file.
        A screen the secret.device ladder reports unavailable restarts
        the file on the host; any other device failure raises."""
        from trivy_tpu_torch.secret.stream import stream_scan

        return stream_scan(self, path, source, use_device)

    def scan_file(self, path: str, content: bytes,
                  rules: list[CompiledRule] | None = None) -> Secret | None:
        if self.skip_file(path) or self.path_allowed(path):
            return None
        if b"\x00" in content[:8000]:
            return None  # binary
        if rules is None:
            rules = self._candidate_rules_fast(content)
        findings: list[SecretFinding] = []
        pos_cache: dict = {}  # shared AC literal positions per file
        for cr in rules:
            if cr.path_rx is not None and not cr.path_rx.match(path):
                continue
            for m in self._host_matches(cr, content, pos_cache):
                secret_bytes, start, end = self._secret_span(cr, m)
                if secret_bytes is None:
                    continue
                if self._allowed(path, secret_bytes):
                    continue
                findings.append(self._finding(cr, content, start, end))
        if not findings:
            return None
        findings.sort(key=lambda f: (f.start_line, f.rule_id))
        return Secret(file_path=path, findings=findings)

    def _secret_span(self, cr: CompiledRule, m: re.Match):
        if cr.rule.secret_group:
            try:
                s = m.group(cr.rule.secret_group)
            except IndexError:
                return None, 0, 0
            if s is None:
                return None, 0, 0
            return s, m.start(cr.rule.secret_group), m.end(cr.rule.secret_group)
        return m.group(0), m.start(), m.end()

    def _finding(self, cr: CompiledRule, content: bytes,
                 start: int, end: int) -> SecretFinding:
        start_line = content.count(b"\n", 0, start) + 1
        end_line = content.count(b"\n", 0, end) + 1
        # censored match line (scanner.go findLocation + censoring)
        line_start = content.rfind(b"\n", 0, start) + 1
        line_end = content.find(b"\n", end)
        if line_end < 0:
            line_end = len(content)
        censored = (
            content[line_start:start]
            + b"*" * min(end - start, 60)
            + content[end:line_end]
        )
        match_text = censored.decode("utf-8", "replace")
        if len(match_text) > 120:
            match_text = match_text[:117] + "..."
        return SecretFinding(
            rule_id=cr.rule.id,
            category=cr.rule.category,
            severity=cr.rule.severity,
            title=cr.rule.title,
            start_line=start_line,
            end_line=end_line,
            match=match_text,
            offset=start,
        )


class _ScreenEngine:
    """MatchScheduler-compatible facade over the anchor screen: a
    'query' is one packed uint8[CHUNK] super-buffer row, a 'result'
    that chunk's rule-hit bool row — the scheduler's coalescing /
    fairness / deadline machinery is reused verbatim for the secret
    lane, so concurrent scans share device dispatches. The screen is
    the matcher's kernel: the anchor kernel, or the conv kernel for a
    conv bank."""

    __slots__ = ("_scanner",)

    def __init__(self, scanner: SecretScanner):
        self._scanner = scanner

    def detect(self, chunks: list) -> list:
        """Private re-dispatch path (the scheduler's per-slice fault
        isolation)."""
        m = self._scanner._matcher
        return list(m._run_chunks(np.stack(chunks)))

    def submit(self, lists: list[list]) -> list[list]:
        """ONE screen dispatch over the coalesced union of every
        waiting scan's chunks."""
        m = self._scanner._matcher
        flat = [c for qs in lists for c in qs]
        hits = m._run_chunks(np.stack(flat))
        out: list[list] = []
        i = 0
        for qs in lists:
            out.append(list(hits[i: i + len(qs)]))
            i += len(qs)
        return out
