"""Dockerfile checks (reference trivy-checks checks/docker/*.rego;
IDs match the published DS rules).

Copy of trivy_tpu/iac/checks/docker.py, whole.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.iac.check import Cause, check

_D = ("dockerfile",)


def _cause(instr, msg, stage=None) -> Cause:
    return Cause(message=msg, resource=stage.name if stage else "",
                 start_line=instr.start_line, end_line=instr.end_line)


def _run_commands(df, stage):
    """Shell commands from RUN instructions, split on &&/;."""
    for instr in df.by_cmd("RUN", stage):
        for part in re.split(r"&&|;", instr.value.replace("\\\n", " ")):
            yield instr, part.strip()


@check("DS001", "':latest' tag used", severity="MEDIUM", file_types=_D,
       avd_id="AVD-DS-0001", provider="dockerfile", service="general",
       resolution="Add a tag to the image in the 'FROM' statement")
def latest_tag(ctx):
    out = []
    stage_names = {s.name for s in ctx.dockerfile.stages}
    for stage in ctx.dockerfile.stages:
        base = stage.base
        if base in stage_names and base != stage.name:
            continue  # references an earlier stage
        if base.lower() == "scratch" or base.startswith("$"):
            continue
        ref = base.rsplit("@", 1)[0]
        tag = ref.rsplit(":", 1)[1] if ":" in ref.split("/")[-1] else ""
        if "@" in base:
            continue  # digest-pinned
        if tag == "latest" or not tag:
            out.append(Cause(
                message=f"Specify a tag in the 'FROM' statement for image "
                        f"'{ref.split(':')[0]}'",
                resource=stage.name, start_line=stage.start_line,
                end_line=stage.start_line,
            ))
    return out


@check("DS002", "Image user should not be 'root'", severity="HIGH",
       file_types=_D, avd_id="AVD-DS-0002", provider="dockerfile",
       service="general",
       resolution="Add 'USER <non root user name>' line to the Dockerfile")
def root_user(ctx):
    df = ctx.dockerfile
    stage = df.final_stage
    if stage is None:
        return []
    users = df.by_cmd("USER", stage) or df.by_cmd("USER")
    if not users:
        return [Cause(
            message="Specify at least 1 USER command in Dockerfile with "
                    "non-root user as argument",
            resource=stage.name, start_line=stage.start_line,
            end_line=stage.start_line,
        )]
    last = users[-1]
    if last.value.split(":")[0].strip() in ("root", "0"):
        return [_cause(last, "Last USER command in Dockerfile should not "
                             "be 'root'", stage)]
    return []


@check("DS004", "Port 22 exposed", severity="MEDIUM", file_types=_D,
       avd_id="AVD-DS-0004", provider="dockerfile", service="general",
       resolution="Remove 'EXPOSE 22' statement from the Dockerfile")
def expose_ssh(ctx):
    out = []
    for instr in ctx.dockerfile.by_cmd("EXPOSE"):
        for port in instr.value.split():
            if port.split("/")[0] == "22":
                out.append(_cause(instr,
                                  "Port 22 should not be exposed in "
                                  "Dockerfile"))
    return out


@check("DS005", "ADD instead of COPY", severity="LOW", file_types=_D,
       avd_id="AVD-DS-0005", provider="dockerfile", service="general",
       resolution="Use COPY instead of ADD")
def add_instead_of_copy(ctx):
    out = []
    for instr in ctx.dockerfile.by_cmd("ADD"):
        v = instr.value
        # ADD is legitimate for remote URLs and auto-extracted archives
        if re.search(r"https?://", v) or re.search(
            r"\.(tar|tar\.\w+|tgz|tbz2|txz|zst)(\s|\"|$)", v
        ):
            continue
        out.append(_cause(instr, f"Consider using 'COPY {v}' command "
                                 f"instead of 'ADD {v}'"))
    return out


@check("DS010", "RUN using 'sudo'", severity="HIGH", file_types=_D,
       avd_id="AVD-DS-0010", provider="dockerfile", service="general",
       resolution="Don't use sudo in RUN")
def run_sudo(ctx):
    out = []
    for instr, cmd in _run_commands(ctx.dockerfile, None):
        if cmd.startswith("sudo ") or cmd == "sudo":
            out.append(_cause(instr, "Using 'sudo' in Dockerfile should "
                                     "be avoided"))
    return out


@check("DS012", "Duplicate stage alias", severity="CRITICAL",
       file_types=_D, avd_id="AVD-DS-0012", provider="dockerfile",
       service="general",
       resolution="Use unique aliases in multi-stage builds")
def duplicate_alias(ctx):
    seen = {}
    out = []
    for stage in ctx.dockerfile.stages:
        if stage.name != stage.base and stage.name in seen:
            out.append(Cause(
                message=f"Duplicate aliases '{stage.name}' are found in "
                        f"different FROM statements",
                resource=stage.name, start_line=stage.start_line,
                end_line=stage.start_line,
            ))
        seen[stage.name] = stage
    return out


@check("DS013", "'RUN cd ...' to change directory", severity="MEDIUM",
       file_types=_D, avd_id="AVD-DS-0013", provider="dockerfile",
       service="general", resolution="Use WORKDIR instead of 'RUN cd'")
def run_cd(ctx):
    out = []
    for instr, cmd in _run_commands(ctx.dockerfile, None):
        if re.match(r"cd\s+/", cmd):
            out.append(_cause(
                instr, f"RUN should not be used to change directory: "
                       f"'{cmd}'. Use 'WORKDIR' statement instead."))
    return out


@check("DS016", "Multiple CMD instructions", severity="CRITICAL",
       file_types=_D, avd_id="AVD-DS-0016", provider="dockerfile",
       service="general",
       resolution="Keep one CMD per stage")
def multiple_cmds(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        cmds = ctx.dockerfile.by_cmd("CMD", stage)
        for extra in cmds[:-1]:
            out.append(_cause(
                extra, "There are multiple CMD instructions; only "
                       "the last one takes effect", stage))
    return out


@check("DS017", "'RUN apt-get update' without matching install",
       severity="HIGH", file_types=_D, avd_id="AVD-DS-0017",
       provider="dockerfile", service="general",
       resolution="Combine apt-get update and install in one RUN")
def apt_update_alone(ctx):
    out = []
    for instr in ctx.dockerfile.by_cmd("RUN"):
        text = instr.value
        if re.search(r"apt(-get)?\s+update", text) and not re.search(
            r"apt(-get)?\s+(-\S+\s+)*install", text
        ):
            out.append(_cause(
                instr, "The instruction 'RUN <package-manager> update' "
                       "should always be followed by "
                       "'<package-manager> install' in the same RUN "
                       "statement"))
    return out


@check("DS021", "'apt-get install' without '-y'", severity="HIGH",
       file_types=_D, avd_id="AVD-DS-0021", provider="dockerfile",
       service="general",
       resolution="Add -y to apt-get install")
def apt_install_no_yes(ctx):
    out = []
    for instr, cmd in _run_commands(ctx.dockerfile, None):
        if re.search(r"apt(-get)?\s+(-\S+\s+)*install", cmd):
            if not re.search(r"(^|\s)(-y|--yes|--assume-yes|-qq)(\s|$)",
                             cmd):
                out.append(_cause(
                    instr, f"'-y' flag is missed: '{cmd}'"))
    return out


@check("DS024", "'apt-get dist-upgrade' used", severity="HIGH",
       file_types=_D, avd_id="AVD-DS-0024", provider="dockerfile",
       service="general",
       resolution="Remove apt-get dist-upgrade")
def dist_upgrade(ctx):
    out = []
    for instr, cmd in _run_commands(ctx.dockerfile, None):
        if re.search(r"apt-get\s+(-\S+\s+)*dist-upgrade", cmd):
            out.append(_cause(
                instr, "'apt-get dist-upgrade' should not be used in "
                       "Dockerfile"))
    return out


@check("DS025", "'apk add' without '--no-cache'", severity="HIGH",
       file_types=_D, avd_id="AVD-DS-0025", provider="dockerfile",
       service="general",
       resolution="Add --no-cache to apk add")
def apk_no_cache(ctx):
    out = []
    for instr, cmd in _run_commands(ctx.dockerfile, None):
        if re.search(r"apk\s+(-\S+\s+)*add", cmd) and \
                "--no-cache" not in cmd:
            out.append(_cause(
                instr, f"'--no-cache' is missed: '{cmd}'"))
    return out


@check("DS026", "No HEALTHCHECK defined", severity="LOW", file_types=_D,
       avd_id="AVD-DS-0026", provider="dockerfile", service="general",
       resolution="Add HEALTHCHECK instruction in your docker container "
                  "images")
def no_healthcheck(ctx):
    df = ctx.dockerfile
    if not df.stages:
        return []
    if df.by_cmd("HEALTHCHECK"):
        return []
    stage = df.final_stage
    return [Cause(
        message="Add HEALTHCHECK instruction in your docker container "
                "images",
        resource=stage.name, start_line=stage.start_line,
        end_line=stage.start_line,
    )]


@check("DS029", "'apt-get install' without '--no-install-recommends'",
       severity="HIGH", file_types=_D, avd_id="AVD-DS-0029",
       provider="dockerfile", service="general",
       resolution="Add --no-install-recommends to apt-get install")
def apt_no_recommends(ctx):
    out = []
    for instr, cmd in _run_commands(ctx.dockerfile, None):
        if re.search(r"apt-get\s+(-\S+\s+)*install", cmd) and \
                "--no-install-recommends" not in cmd:
            out.append(_cause(
                instr, f"'--no-install-recommends' flag is missed: "
                       f"'{cmd}'"))
    return out


# --------------------------------------------- breadth wave (r5): the
# remaining published DS rules (reference trivy-checks checks/docker)


@check("DS006", "COPY --from references its own FROM alias",
       severity="CRITICAL", file_types=_D, avd_id="AVD-DS-0006",
       provider="dockerfile", service="general",
       resolution="Reference a previous stage in COPY --from")
def copy_from_own_alias(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        for instr in ctx.dockerfile.by_cmd("COPY", stage):
            for flag in instr.flags:
                if flag.startswith("--from=") and \
                        flag[7:] == stage.name:
                    out.append(_cause(
                        instr, f"COPY '--from' references the current "
                               f"stage '{stage.name}'", stage))
    return out


@check("DS007", "Multiple ENTRYPOINT instructions in a stage",
       severity="CRITICAL", file_types=_D, avd_id="AVD-DS-0007",
       provider="dockerfile", service="general",
       resolution="Keep only one ENTRYPOINT per stage")
def multiple_entrypoints_ds007(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        eps = ctx.dockerfile.by_cmd("ENTRYPOINT", stage)
        if len(eps) > 1:
            out.append(_cause(
                eps[-1], f"There are {len(eps)} duplicate ENTRYPOINT "
                         f"instructions", stage))
    return out


@check("DS008", "Exposed port is out of range", severity="CRITICAL",
       file_types=_D, avd_id="AVD-DS-0008", provider="dockerfile",
       service="general", resolution="Use ports between 0 and 65535")
def port_out_of_range(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        for instr in ctx.dockerfile.by_cmd("EXPOSE", stage):
            for port in instr.value.split():
                num = port.split("/")[0]
                if num.isdigit() and not 0 <= int(num) <= 65535:
                    out.append(_cause(
                        instr, f"'EXPOSE' port {num} is out of range",
                        stage))
    return out


@check("DS009", "WORKDIR path is relative", severity="HIGH",
       file_types=_D, avd_id="AVD-DS-0009", provider="dockerfile",
       service="general", resolution="Use absolute WORKDIR paths")
def workdir_relative(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        for instr in ctx.dockerfile.by_cmd("WORKDIR", stage):
            path = instr.value.strip().strip('"').strip("'")
            if path and not path.startswith(("/", "$", "%")) \
                    and ":" not in path[:3]:    # windows C:\ paths
                out.append(_cause(
                    instr, f"WORKDIR path '{path}' should be absolute",
                    stage))
    return out


@check("DS011", "COPY with multiple sources needs a directory "
       "destination", severity="CRITICAL", file_types=_D,
       avd_id="AVD-DS-0011", provider="dockerfile", service="general",
       resolution="End the destination with / when copying multiple "
                  "sources")
def copy_multiple_sources(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        for instr in ctx.dockerfile.by_cmd("COPY", stage):
            arr = instr.json_array()
            parts = arr if arr is not None else instr.value.split()
            parts = [p for p in parts
                     if not p.startswith("--")]   # strip flags
            if len(parts) > 2 and not parts[-1].endswith("/") \
                    and not parts[-1] in (".", "./"):
                out.append(_cause(
                    instr, f"When copying multiple sources the "
                           f"destination '{parts[-1]}' must be a "
                           f"directory (end with /)", stage))
    return out


@check("DS014", "RUN uses both wget and curl", severity="LOW",
       file_types=_D, avd_id="AVD-DS-0014", provider="dockerfile",
       service="general",
       resolution="Standardize on either wget or curl")
def wget_and_curl(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        tools = set()
        first = None
        for instr, cmd in _run_commands(ctx.dockerfile, stage):
            tok = cmd.split()[:1]
            if tok and tok[0] in ("wget", "curl"):
                tools.add(tok[0])
                first = first or instr
        if {"wget", "curl"} <= tools and first is not None:
            out.append(_cause(
                first, "Both wget and curl are used — pick one",
                stage))
    return out


@check("DS015", "yum install without 'yum clean all'", severity="HIGH",
       file_types=_D, avd_id="AVD-DS-0015", provider="dockerfile",
       service="general",
       resolution="Add 'yum clean all' after yum install")
def yum_clean_missing(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        for instr in ctx.dockerfile.by_cmd("RUN", stage):
            text = instr.value
            if re.search(r"\byum\b[^|;&]*\binstall\b", text) and \
                    "clean all" not in text:
                out.append(_cause(
                    instr, "'yum install' without a following "
                           "'yum clean all'", stage))
    return out


@check("DS019", "zypper install without 'zypper clean'",
       severity="HIGH", file_types=_D, avd_id="AVD-DS-0019",
       provider="dockerfile", service="general",
       resolution="Add 'zypper clean' after zypper use")
def zypper_clean_missing(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        for instr in ctx.dockerfile.by_cmd("RUN", stage):
            text = instr.value
            if re.search(r"\bzypper\b[^|;&]*\b(install|in|remove|rm|"
                         r"source-install|si|patch)\b", text) and \
                    not re.search(r"\bzypper\s+(clean|cc)\b", text):
                out.append(_cause(
                    instr, "'zypper' use without a following "
                           "'zypper clean'", stage))
    return out


@check("DS020", "'zypper dist-upgrade' used", severity="HIGH",
       file_types=_D, avd_id="AVD-DS-0020", provider="dockerfile",
       service="general",
       resolution="Do not run full distribution upgrades in images")
def zypper_dist_upgrade(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        for instr, cmd in _run_commands(ctx.dockerfile, stage):
            if re.search(r"\bzypper\s+(dist-upgrade|dup)\b", cmd):
                out.append(_cause(
                    instr, "'zypper dist-upgrade' should not be used",
                    stage))
    return out


@check("DS022", "Deprecated MAINTAINER used", severity="LOW",
       file_types=_D, avd_id="AVD-DS-0022", provider="dockerfile",
       service="general",
       resolution="Use a LABEL maintainer= instead")
def maintainer_deprecated(ctx):
    out = []
    for stage in ctx.dockerfile.stages:
        for instr in ctx.dockerfile.by_cmd("MAINTAINER", stage):
            out.append(_cause(
                instr, "MAINTAINER is deprecated, use "
                       "'LABEL maintainer=...'", stage))
    return out


@check("DS023", "Multiple HEALTHCHECK instructions", severity="MEDIUM",
       file_types=_D, avd_id="AVD-DS-0023", provider="dockerfile",
       service="general",
       resolution="Keep a single HEALTHCHECK")
def multiple_healthchecks(ctx):
    hcs = ctx.dockerfile.by_cmd("HEALTHCHECK")
    if len(hcs) > 1:
        return [_cause(hcs[-1],
                       f"There are {len(hcs)} HEALTHCHECK "
                       f"instructions")]
    return []
