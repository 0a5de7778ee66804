"""The benchmark's parts, found by name: BENCHMARK.json at the root of the
checkout, ``configs/<file>`` (as BENCHMARK.json names it),
``traffic/<mix>.json`` and ``metrics/<metric>.py``.  A new configuration,
mix, metric or cell is a new file or entry; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _by_name(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, root: str, name: str) -> dict:
    with open(os.path.join(root, _by_name(bench["configs"], name, "config")["file"])) as fh:
        out = json.load(fh)
    out.setdefault("name", name)
    return out


def traffic(root: str, name: str) -> dict:
    with open(os.path.join(root, os.path.basename(HERE), "traffic", f"{name}.json")) as fh:
        out = json.load(fh)
    out.setdefault("name", name)
    return out


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` list and those whose list names it."""
    return [m for m in bench[kind] if "workloads" not in m or cell_name in m["workloads"]]


def reader(root: str, metric: str):
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(root, os.path.basename(HERE), "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(root: str, metrics: List[dict], run: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds a
    number; the others are left out."""
    out = {}
    for m in metrics:
        v = reader(root, m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
