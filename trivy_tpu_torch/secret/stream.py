"""Streaming chunked secret scanning for files over the whole-file
threshold. Port of trivy_tpu/secret/stream.py.

The reference warns at 10 MiB and scans anyway (secret.go:110); the
pre-streaming device path additionally materialized every file into the
packed super-buffers whole.  This module scans a file of any size in
``stream_chunk_bytes()``-sized steps with overlapping halo windows
sized by ``SecretScanner.MAX_WINDOW_WIDTH``, producing findings
**byte-identical** to ``scan_file`` on the full content:

- **Bounded rules** (max match width <= halo, no position assertions)
  are scanned with a per-rule *resume cursor* that carries finditer's
  non-overlap consumption across steps: each step searches
  ``[max(owner_start - halo, resume), owner_end)`` for match STARTS in
  the step's owner region, over a retained buffer that always holds a
  full halo + lookahead around it — the match sequence is exactly the
  whole-file ``finditer`` sequence.
- **Anchored rules** additionally run the device anchor screen per
  step (the same packed super-buffers as the batch path) and verify
  the real regex only inside candidate windows, deduped by secret
  span — mirroring the batch device tiers.
- **Oversized rules** (unbounded width, or ``^``/``\\b``/lookaround
  assertions whose window semantics cannot be sliced) keep exact
  whole-file semantics: they are gated by the streamed keyword pass
  and, only when a keyword (or a keyword-less oversized rule) demands
  it, run over the full content in a final pass.  The builtin set's
  oversized rules (PEM blocks, JWTs, basic-auth URLs, dockerconfig)
  are all keyword-gated, so a big file without their keywords streams
  with bounded memory end to end.
- **Keyword prefilter semantics** are whole-file, exactly like the
  reference: presence accumulates over overlapping step regions (one
  case-folded native-AC pass per step) and gates collected findings at
  EOF — a keyword at the end of the file enables matches at the start.

Line numbers, censored match text (including the 120-char truncation)
and offsets are reproduced exactly via running newline counts and a
bounded head snapshot of the line open at the retained-buffer base.

A device failure at any step raises: the port never restarts a file
on the host behind the caller's back.
"""

from __future__ import annotations

import numpy as np

from trivy_tpu_torch.types.artifact import Secret, SecretFinding

# bytes of line-head / suffix margin retained for censored-text parity:
# the 120-char truncation consumes at most ~480 bytes (4-byte UTF-8
# worst case), so 512 bytes around a match pin the rendered text
SNIPPET = 512


class _Source:
    """Byte source for one streamed file: bytes, or a seekable binary
    file object (the oversized-rule full pass needs rewind)."""

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray, memoryview)):
            self._bytes = bytes(source)
            self._f = None
        else:
            self._bytes = None
            self._f = source
        self._pos = 0

    def reset(self) -> None:
        self._pos = 0
        if self._f is not None:
            self._f.seek(0)

    def read(self, n: int) -> bytes:
        if self._bytes is not None:
            out = self._bytes[self._pos: self._pos + n]
            self._pos += len(out)
            return out
        parts = []
        got = 0
        while got < n:
            b = self._f.read(n - got)
            if not b:
                break
            parts.append(b)
            got += len(b)
        return b"".join(parts)

    def full(self) -> bytes:
        if self._bytes is not None:
            return self._bytes
        self._f.seek(0)
        return self._f.read()


def stream_scan(scanner, path: str, source,
                use_device=True) -> Secret | None:
    """SecretScanner.scan_stream implementation (see scanner method
    docstring)."""
    if scanner.skip_file(path) or scanner.path_allowed(path):
        return None
    src = _Source(source)
    head = src.read(8000)
    if b"\x00" in head:
        return None  # binary
    if use_device == "hybrid":
        use_device = bool(scanner._accel_backend()
                          and scanner._hybrid_device_ok())
    if use_device:
        scanner._ensure_tiers()
    return _run(scanner, path, src, device=bool(use_device))


def _run(scanner, path: str, src: _Source, device: bool) -> Secret | None:
    from trivy_tpu_torch.ops.secret_nfa import (
        CHUNK,
        K_ANCHOR,
        chunk_files_packed,
        merge_windows,
    )
    from trivy_tpu_torch.secret.scanner import stream_chunk_bytes

    ht = scanner._ensure_host_tiers()
    rules = scanner.rules
    H = scanner.MAX_WINDOW_WIDTH
    C = max(stream_chunk_bytes(), 4 * H + CHUNK)
    # the retained prefix must always cover a deferred candidate
    # window's lo: one full step back plus halo + one device chunk
    keep_len = C + H + CHUNK + 64

    if device and scanner._tiers["bank"] is not None:
        anchor_rules = scanner._tiers["anchor_rules"]
        anchored_idx = {scanner._rule_pos[id(cr)]
                        for (cr, _lo, _hi, _k) in anchor_rules}
    else:
        anchor_rules = []
        anchored_idx = set()

    def path_ok(i: int) -> bool:
        rx = rules[i].path_rx
        return rx is None or rx.match(path) is not None

    cursor_idx = [i for i in sorted(ht["bounded"])
                  if i not in anchored_idx and path_ok(i)]
    oversized_idx = [i for i in sorted(ht["oversized"]) if path_ok(i)]

    resume = {i: 0 for i in cursor_idx}
    pending_windows: dict[int, list] = {}
    spans: set[tuple[str, int, int]] = set()
    collected: list[tuple] = []  # (cr, SecretFinding)
    kws_present: set[bytes] = set()

    prev = b""
    ret_base = 0
    nl_upto_base = 0
    line_start_abs = 0
    line_head = b""
    owner_start = 0
    pending_screen = None

    src.reset()
    cur = src.read(C)
    if not cur:
        return None
    nxt = src.read(C)

    def consider(cr, ret, s_l: int, e_l: int, m, dedupe: bool) -> None:
        secret_bytes, g_s, g_e = scanner._secret_span(cr, m)
        if secret_bytes is None:
            return
        abs_s, abs_e = ret_base + g_s, ret_base + g_e
        if dedupe:
            key = (cr.rule.id, abs_s, abs_e)
            if key in spans:
                return
            spans.add(key)
        if scanner._allowed(path, secret_bytes):
            return
        collected.append((cr, _finding_local(
            scanner, cr, ret, g_s, g_e, ret_base, nl_upto_base,
            line_start_abs, line_head)))

    while cur:
        final = not nxt
        ret = prev + cur + nxt
        owner_end = owner_start + len(cur)
        avail_end = ret_base + len(ret)

        # refill the open-line head snapshot from the retained buffer
        if len(line_head) < SNIPPET:
            off = line_start_abs + len(line_head) - ret_base
            if 0 <= off < len(ret):
                line_head += ret[off: off + SNIPPET - len(line_head)]

        # whole-file keyword presence, accumulated over halo-overlapped
        # step regions (straddling keywords are inside some region)
        kw_lo = max(owner_start - H, 0)
        kws_present |= scanner._kw_present_set(
            ret[kw_lo - ret_base: owner_end - ret_base])

        # device anchor screen: dispatch step k, absorb step k-1's hits
        # (dispatch-first pipelining across steps)
        this_screen = None
        if anchor_rules:
            scr_lo = max(owner_start - (K_ANCHOR - 1), 0)
            scr = ret[scr_lo - ret_base: owner_end - ret_base]
            chunks, segments = chunk_files_packed([scr])
            this_screen = (scanner._screen_submit(chunks), segments,
                           scr_lo)
        screens = [s for s in (pending_screen,
                               this_screen if final else None) if s]
        pending_screen = None if final else this_screen
        for collect, segments, scr_b in screens:
            hits = collect()
            n_a = len(anchor_rules)
            ci, ri = np.nonzero(hits[:, :n_a])
            for c, r in zip(ci.tolist(), ri.tolist()):
                cr, pad_lo, pad_hi, _kind = anchor_rules[r]
                if not path_ok(scanner._rule_pos[id(cr)]):
                    continue
                for _fi, f_off, _c_off, seg_len in segments[c]:
                    lo = max(scr_b + f_off - pad_lo, 0)
                    hi = scr_b + f_off + seg_len + pad_hi
                    pending_windows.setdefault(r, []).append((lo, hi))

        # verify anchored candidate windows whose bytes (plus the
        # censor margin) are fully retained; defer the rest one step
        for r, wins in list(pending_windows.items()):
            cr = anchor_rules[r][0]
            ready = [w for w in wins
                     if final or w[1] + SNIPPET <= avail_end]
            if not ready:
                continue
            pending_windows[r] = [w for w in wins
                                  if not (final
                                          or w[1] + SNIPPET <= avail_end)]
            for lo, hi in merge_windows(ready):
                lo_l = max(lo, ret_base) - ret_base
                hi_l = min(hi, avail_end) - ret_base
                if lo_l >= hi_l:
                    continue
                for m in cr.regex.finditer(ret, lo_l, hi_l):
                    consider(cr, ret, m.start(), m.end(), m, dedupe=True)

        # bounded cursor rules: exact whole-file finditer emulation
        for i in cursor_idx:
            cr = rules[i]
            start_l = max(owner_start - H, resume[i], ret_base) - ret_base
            if start_l >= len(ret):
                continue
            for m in cr.regex.finditer(ret, start_l):
                abs_s = ret_base + m.start()
                if abs_s < owner_start:
                    continue  # consumed in an earlier step
                if abs_s >= owner_end and not final:
                    break  # next step owns it (with full lookahead)
                resume[i] = ret_base + m.end()
                consider(cr, ret, m.start(), m.end(), m, dedupe=False)

        if final:
            break
        # rotate: drop all but keep_len bytes of [ret_base, owner_end)
        combined = prev + cur
        new_prev = combined[-keep_len:] \
            if len(combined) > keep_len else combined
        dropped_len = len(combined) - len(new_prev)
        if dropped_len:
            dropped = combined[:dropped_len]
            nl_upto_base += dropped.count(b"\n")
            r_nl = dropped.rfind(b"\n")
            if r_nl >= 0:
                line_start_abs = ret_base + r_nl + 1
                line_head = dropped[r_nl + 1: r_nl + 1 + SNIPPET]
            ret_base += dropped_len
        prev = new_prev
        owner_start = owner_end
        cur = nxt
        nxt = src.read(C)

    # EOF: whole-file keyword gate over the collected bounded findings
    findings = [f for cr, f in collected
                if not cr.keywords
                or any(k in kws_present for k in cr.keywords)]

    # oversized rules keep exact whole-file semantics; only keyword-
    # demanded (or keyword-less) ones force the full-content pass
    need = [rules[i] for i in oversized_idx
            if not rules[i].keywords
            or any(k in kws_present for k in rules[i].keywords)]
    if need:
        full = src.full()
        for cr in need:
            for m in cr.regex.finditer(full):
                secret_bytes, g_s, g_e = scanner._secret_span(cr, m)
                if secret_bytes is None:
                    continue
                if scanner._allowed(path, secret_bytes):
                    continue
                findings.append(scanner._finding(cr, full, g_s, g_e))

    if not findings:
        return None
    # scan_file sorts (start_line, rule_id) stably over finditer order;
    # adding the offset reproduces that order from the streamed
    # collection sequence exactly
    findings.sort(key=lambda f: (f.start_line, f.rule_id, f.offset))
    return Secret(file_path=path, findings=findings)


def _finding_local(scanner, cr, ret: bytes, s_l: int, e_l: int,
                   ret_base: int, nl_upto_base: int,
                   line_start_abs: int, line_head: bytes):
    """SecretFinding for a match at ret-local [s_l, e_l), byte-identical
    to scanner._finding on the full content: running newline counts
    give the absolute line numbers, and the retained buffer (plus the
    open-line head snapshot when the line began before it) reproduces
    the censored text including its 120-char truncation."""
    start_line = nl_upto_base + ret.count(b"\n", 0, s_l) + 1
    end_line = nl_upto_base + ret.count(b"\n", 0, e_l) + 1
    r_nl = ret.rfind(b"\n", 0, s_l)
    if r_nl >= 0:
        prefix = ret[r_nl + 1: s_l]
    else:
        # line opened before the retained buffer: the head snapshot
        # holds its first SNIPPET bytes — enough to pin the <=120-char
        # rendered text (the true prefix is longer than the truncation
        # can ever show)
        plen = (ret_base + s_l) - line_start_abs
        prefix = line_head[:plen] if plen <= len(line_head) else line_head
    e_nl = ret.find(b"\n", e_l)
    suffix = ret[e_l:e_nl] if e_nl >= 0 else ret[e_l:]
    censored = prefix + b"*" * min(e_l - s_l, 60) + suffix
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
        offset=ret_base + s_l,
    )
