"""Layered option resolution (reference pkg/flag: CLI flag > env
TRIVY_TPU_* > config file trivy-tpu.yaml > default, realized there by
viper binding; here as argparse post-processing).

Copy of trivy_tpu/cli/config.py. The environment layer reads the same
TRIVY_TPU_* names as the reference's. `UNPORTED` (options that the
reference's scan subcommands have and the port's lack) and
`K8S_UNPORTED` (the same for `kubernetes`) are empty: the port's parsers
have every option of the reference's. Their check stays, so an option
given a value through the environment or the config file that the
reference would act on and the port lacks is refused with one error
line: the port must not write a different report without a word.
"""

from __future__ import annotations

import os

from trivy_tpu_torch.log import logger

_log = logger("config")

CONFIG_NAMES = ("trivy-tpu.yaml", "trivy.yaml")
ENV_PREFIX = "TRIVY_TPU_"

# dests of the reference's scan-subcommand parsers (image, sbom,
# filesystem, fs, rootfs, repository, repo, vm, config) that the port's
# parsers lack, each with the values that leave the reference's scan as
# it is: its parser's default first, then the spellings its code reads
# as unset (the empty string where it tests the option's truth). None
# is left.
UNPORTED: dict = {}

# the same for the reference's `kubernetes` parser: the port's has every
# option of it
K8S_UNPORTED: dict = {}


def _load_config_file(path: str | None) -> dict:
    import yaml

    candidates = [path] if path else list(CONFIG_NAMES)
    for p in candidates:
        if p and os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                doc = yaml.safe_load(f) or {}
            if not isinstance(doc, dict):
                _log.warn("ignoring malformed config file", path=p)
                return {}
            _log.debug("loaded config file", path=p)
            return _flatten(doc)
    if path:
        raise FileNotFoundError(f"config file not found: {path}")
    return {}


def _flatten(doc: dict, prefix: str = "") -> dict:
    """scan: {skip-dirs: [...]} -> {"scan.skip-dirs": [...]}, and the
    leaf name alone is also addressable ("skip-dirs")."""
    out: dict = {}
    for k, v in doc.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
            out.setdefault(k, v)
    return out


def _coerce(value, default):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(default, int) and not isinstance(default, bool):
        return int(value)
    if isinstance(default, list):
        if isinstance(value, str):
            return [v for v in value.split(",") if v]
        return list(value)
    if isinstance(value, list):  # config list for a comma-joined flag
        return ",".join(str(v) for v in value)
    if isinstance(value, str) and value.startswith("~"):
        return os.path.expanduser(value)
    return value


def _all_defaults(parser) -> dict:
    """Defaults across the main parser AND every subparser (argparse's
    get_default only sees the top level)."""
    import argparse

    out: dict = {}
    stack = [parser]
    while stack:
        p = stack.pop()
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                stack.extend(a.choices.values())
            elif a.dest and a.dest != "help":
                out.setdefault(a.dest, a.default)
    return out


def apply_layers(args, parser, argv: list[str]) -> None:
    """Overlay env + config-file values onto argparse defaults; values
    given on the command line always win. Raises ValueError on
    uncoercible env/config values (caught by main's error rendering)."""
    cfg = _load_config_file(getattr(args, "config", None))
    command = getattr(args, "command", None)
    # the port's `server`, `watch` and `chaos` parsers have every option
    # of the reference's
    if command in ("kubernetes", "k8s"):
        _refuse_unported(cfg, K8S_UNPORTED)
    elif command not in (None, "version", "db", "convert", "server",
                         "watch", "chaos"):
        _refuse_unported(cfg, UNPORTED)
    explicit = _explicit_dests(parser, argv)
    defaults = _all_defaults(parser)
    for dest, value in vars(args).copy().items():
        if dest in ("command", "config") or dest in explicit:
            continue
        if dest not in defaults or value != defaults[dest]:
            continue  # not a flag, or already non-default
        default = defaults[dest]
        env_key = ENV_PREFIX + dest.upper().replace("-", "_")
        flag_key = dest.replace("_", "-")
        try:
            if env_key in os.environ:
                setattr(args, dest, _coerce(os.environ[env_key], default))
            elif flag_key in cfg:
                setattr(args, dest, _coerce(cfg[flag_key], default))
        except (ValueError, TypeError) as exc:
            raise ValueError(
                f"invalid value for {flag_key!r} from environment/config: "
                f"{exc}"
            ) from exc


def _refuse_unported(cfg: dict, unported: dict) -> None:
    """Raise ValueError (one line) when the environment or the config
    file gives an option the port does not have yet a value that the
    reference would act on. The layers apply as in `apply_layers`: the
    environment first, and the config file only where it is unset."""
    for dest, unset in unported.items():
        env_key = ENV_PREFIX + dest.upper()
        flag_key = dest.replace("_", "-")
        if env_key in os.environ:
            where, raw = f"{env_key} (--{flag_key}) is set in the " \
                "environment", os.environ[env_key]
        elif flag_key in cfg:
            where, raw = f"{flag_key!r} is set in the config file", \
                cfg[flag_key]
        else:
            continue
        try:
            value = _coerce(raw, unset[0])
        except (ValueError, TypeError) as exc:
            raise ValueError(
                f"invalid value for {flag_key!r} from environment/config: "
                f"{exc}"
            ) from exc
        if value not in unset:
            raise ValueError(f"{where}; it is not ported yet")


def _option_dests(parser) -> dict[str, str]:
    """Every option string (short and long) -> its dest, across all
    subparsers."""
    import argparse

    out: dict[str, str] = {}
    stack = [parser]
    while stack:
        p = stack.pop()
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                stack.extend(a.choices.values())
                continue
            for opt in a.option_strings:
                out[opt] = a.dest
    return out


def _explicit_dests(parser, argv: list[str]) -> set[str]:
    """Dests the user actually typed, covering both --long and -x
    short spellings."""
    by_opt = _option_dests(parser)
    out = set()
    for tok in argv:
        if not tok.startswith("-") or tok == "-":
            continue
        opt = tok.split("=", 1)[0]
        if opt in by_opt:
            out.add(by_opt[opt])
        elif not opt.startswith("--") and len(opt) > 2:
            # clustered/attached short option: -ftable
            short = opt[:2]
            if short in by_opt:
                out.add(by_opt[short])
    return out


DEFAULT_CONFIG = """\
# trivy-tpu.yaml — default configuration
# CLI flags override environment (TRIVY_TPU_*), which overrides this file.
format: table
severity: ""
scanners: vuln,secret
pkg-types: os,library
exit-code: 0
parallel: 5
cache-dir: ~/.cache/trivy-tpu
"""


def generate_default_config(path: str | None = None) -> str:
    path = path or "trivy-tpu.yaml"
    if os.path.exists(path):  # reference: refuses to clobber
        raise ValueError(f"config file already exists: {path}")
    # lint: allow[atomic-write] user-requested --generate-default-config output, not program state
    with open(path, "w", encoding="utf-8") as f:
        f.write(DEFAULT_CONFIG)
    return path
