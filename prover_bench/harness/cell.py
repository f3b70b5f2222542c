"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

  BENCHMARK.json "workloads"[name] -> config name, traffic name, chips
  prover_bench/configs/<config>.json        the configuration's sizes
  prover_bench/configs/<config>.py          its circuit, against the port
  prover_bench/reference/configs/<config>.py  the reference's own account of it
  prover_bench/traffic/<traffic>.json       the traffic mix's parameters
  prover_bench/metrics/<metric>.py          a per-layer metric's reader

A later cell, configuration, mix or metric is a set of new files and
entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module (names may hold '-' and '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def checked_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a legal name")
    return name


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list

    def circuit_module(self):
        return load_module(os.path.join(BENCH_DIR, "configs", f"{self.config['name']}.py"),
                           f"prover_bench_config_{self.config['name']}")

    def reference_module(self):
        return load_module(
            os.path.join(BENCH_DIR, "reference", "configs", f"{self.config['name']}.py"),
            f"prover_bench_reference_{self.config['name']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, benchmark_path: str | None = None) -> Cell:
    bench = load_json(benchmark_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[checked_name(name)]
    config = load_json(os.path.join(BENCH_DIR, "configs", f"{checked_name(w['config'])}.json"))
    if config["name"] != w["config"]:
        raise ValueError(f"configs/{w['config']}.json names itself {config['name']!r}")
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{checked_name(w['traffic'])}.json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_module(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{checked_name(name)}.py")
    return load_module(path, f"prover_bench_metric_{name}")


def metric_reader(name: str):
    """``read(data) -> float | None`` of ``metrics/<name>.py``."""
    return metric_module(name).read
