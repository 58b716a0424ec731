"""Dockerfile parser (reference pkg/iac/scanners/dockerfile — the
reference wraps moby/buildkit's parser; this is a from-scratch
instruction parser with stage tracking and line numbers).

Copy of trivy_tpu/iac/parsers/dockerfile.py, whole.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_CONT = re.compile(r"\\\s*$")
_INSTR = re.compile(r"^\s*([A-Za-z]+)\s+(.*)$", re.S)
_COMMENT = re.compile(r"^\s*#")


@dataclass
class Instruction:
    cmd: str = ""          # upper-cased: FROM, RUN, USER, ...
    value: str = ""        # raw argument string (continuations joined)
    flags: list[str] = field(default_factory=list)  # --platform=... etc.
    start_line: int = 0
    end_line: int = 0

    def json_array(self) -> list[str] | None:
        """exec-form arguments, e.g. CMD [\"nginx\"] -> [\"nginx\"]."""
        v = self.value.strip()
        if not v.startswith("["):
            return None
        import json

        try:
            arr = json.loads(v)
        except ValueError:
            return None
        return [str(a) for a in arr] if isinstance(arr, list) else None


@dataclass
class Stage:
    name: str = ""         # FROM ... AS <name>, else the image ref
    base: str = ""         # image ref
    start_line: int = 0
    instructions: list[Instruction] = field(default_factory=list)


@dataclass
class Dockerfile:
    stages: list[Stage] = field(default_factory=list)
    instructions: list[Instruction] = field(default_factory=list)

    @property
    def final_stage(self) -> Stage | None:
        return self.stages[-1] if self.stages else None

    def by_cmd(self, cmd: str, stage: Stage | None = None):
        src = stage.instructions if stage else self.instructions
        return [i for i in src if i.cmd == cmd.upper()]


def parse_dockerfile(content: bytes) -> Dockerfile:
    text = content.decode("utf-8", "replace")
    df = Dockerfile()
    stage: Stage | None = None

    lines = text.splitlines()
    i = 0
    while i < len(lines):
        raw = lines[i]
        if not raw.strip() or _COMMENT.match(raw):
            i += 1
            continue
        start = i + 1
        # join continuation lines, dropping interleaved comments
        parts = []
        while i < len(lines):
            line = lines[i]
            if _COMMENT.match(line) and parts:
                i += 1
                continue
            if _CONT.search(line):
                parts.append(_CONT.sub("", line))
                i += 1
                continue
            parts.append(line)
            i += 1
            break
        joined = "\n".join(parts)
        m = _INSTR.match(joined)
        if not m:
            continue
        cmd = m.group(1).upper()
        rest = m.group(2).strip()
        flags = []
        while rest.startswith("--"):
            flag, _, rest2 = rest.partition(" ")
            flags.append(flag)
            rest = rest2.strip()
        instr = Instruction(cmd=cmd, value=rest, flags=flags,
                            start_line=start, end_line=i)
        if cmd == "FROM":
            fm = re.match(r"(\S+)(?:\s+[Aa][Ss]\s+(\S+))?", rest)
            base = fm.group(1) if fm else rest
            name = (fm.group(2) if fm else None) or base
            stage = Stage(name=name, base=base, start_line=start)
            df.stages.append(stage)
        if stage is not None:
            stage.instructions.append(instr)
        df.instructions.append(instr)
    return df
