"""Discovery by name. The cells, metrics and configurations are listed in
BENCHMARK.json; each configuration is its file under configs/, each cell
its file under workloads/, each traffic generator, entry and metric a
module under traffic/, entries/ and metrics/, loaded from its file and
registered under the file's name."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   + ", ".join(w["name"] for w in bench["workloads"]))


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def workload_file(name: str) -> dict:
    return json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())


def load_module(folder: str, name: str) -> ModuleType:
    """perfbench/<folder>/<name>.py, imported once under a private name."""
    key = f"perfbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder[:-1] if folder.endswith('s') else folder} "
                       f"named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def load_folder(folder: str) -> Dict[str, ModuleType]:
    """Every module of perfbench/<folder>/, by file name."""
    return {p.stem: load_module(folder, p.stem)
            for p in sorted((BENCH_DIR / folder).glob("*.py")) if p.stem != "__init__"}


def metrics_for(bench: dict, cell: str, trace: bool) -> Dict[str, dict]:
    """The metric entries a run of `cell` reports: the end-to-end ones
    without the trace, the per-layer ones with it; each metric only in the
    cells its "workloads" list names, where it has one."""
    listed = bench["per_layer"] if trace else bench["end_to_end"]
    return {m["name"]: m for m in listed if cell in m.get("workloads", [cell])}
