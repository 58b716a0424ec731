"""Small versions of the cells for the harness's CPU tests."""

from __future__ import annotations

import json
import os

import pytest

from portbench.lib import cell


def tiny(workload: str) -> tuple[dict, dict]:
    """-> (configuration, traffic) of `workload` cut to a CPU test's
    size: the same keys, fewer advisories, images and files. A
    `<config>/<traffic>` name takes the two files, which no cell need
    use."""
    if "/" in workload:
        return tiny_files(*workload.split("/"))
    _work, cfg, traffic = cell.cell(cell.load_spec(), workload)
    return shrink(cfg, traffic)


def tiny_files(config: str, traffic: str) -> tuple[dict, dict]:
    """As `tiny`, for a configuration and a traffic mix named by their
    files."""
    with open(os.path.join(cell.HERE, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(cell.HERE, "traffic", f"{traffic}.json")) as f:
        return shrink(cfg, json.load(f))


def shrink(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    if cfg["system"] == "crawl":
        cfg = dict(cfg, advisories=30000)
        traffic = dict(traffic, images_per_call=3,
                       batch_size=1024, warmup_calls=1)
        if traffic.get("registry"):
            traffic["registry"] = dict(traffic["registry"], images=40,
                                       repos=8)
        return cfg, traffic
    big = traffic["size_min"] > 1 << 20
    return cfg, dict(traffic, pool_files=2 if big else 24,
                     files_per_call=1 if big else 8, warmup_files=1,
                     size_min=(11 << 20) if big else 20 << 10,
                     size_max=(11 << 20) + 4096 if big else 96 << 10,
                     planted_share=1.0 if big else 0.25)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"
