"""Everything that belongs to one cell, configuration, traffic mix or
per-layer metric lives in a file of its own under benchmark/, found by
the name that BENCHMARK.json and the workload files give:

- benchmark/workloads/<cell>.json: the configuration, the traffic, the
  harness's parameters for the cell (warm-up frames, last frame, the
  check's sample and limits);
- benchmark/configs/<config>.json: the configuration as it is run
  (`cfg`), its source, `reduced`, `assumed`, the sequence length and the
  scene; or a deployment of another configuration: its `base` and the
  `set` of dotted `cfg` keys it changes (`{"tpu.pipelined": true}`);
- benchmark/traffic/<traffic>.json: the parameters of the generator;
- benchmark/metrics/<metric>.py: one reader a per-layer metric, with its
  unit, layer, source, the end-to-end metric it moves and its cells.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = ("NAME", "UNIT", "BETTER", "SOURCE", "LAYER", "MOVES", "CELLS")


def _json(kind: str, name: str, root: str = HERE) -> dict:
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def workload(name: str, root: str = HERE) -> dict:
    return _json("workloads", name, root)


def config(name: str, root: str = HERE) -> dict:
    conf = _json("configs", name, root)
    if "base" not in conf:
        return conf
    base = config(conf["base"], root)
    out = dict(base, **{k: v for k, v in conf.items()
                        if k not in ("base", "set")})
    out["assumed"] = dict(base["assumed"], **conf.get("assumed", {}))
    out["cfg"] = json.loads(json.dumps(base["cfg"]))
    for key, value in conf["set"].items():
        node = out["cfg"]
        *path, last = key.split(".")
        for part in path:
            node = node[part]
        node[last] = value
    return out


def traffic(name: str, root: str = HERE) -> dict:
    return _json("traffic", name, root)


def names(kind: str, root: str = HERE) -> list:
    """Every name of a kind ('workloads', 'configs', 'traffic' or
    'metrics') that has a file."""
    ext = ".py" if kind == "metrics" else ".json"
    d = os.path.join(root, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def metric(name: str, root: str = HERE) -> ModuleType:
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in KEYS if not hasattr(mod, k)]
    if missing or mod.NAME != name or not callable(getattr(mod, "read",
                                                            None)):
        raise ValueError(f"metric file {path}: missing {missing or 'read'}")
    return mod


def metrics_for(cell: str, root: str = HERE) -> Dict[str, ModuleType]:
    """The per-layer metrics whose CELLS hold `cell` (None: every cell)."""
    out = {}
    for n in names("metrics", root):
        m = metric(n, root)
        if m.CELLS is None or cell in m.CELLS:
            out[n] = m
    return out


def per_layer_entry(m: ModuleType) -> dict:
    """The metric's BENCHMARK.json entry."""
    e = {"name": m.NAME, "unit": m.UNIT, "better": m.BETTER,
         "source": m.SOURCE, "layer": m.LAYER, "moves": m.MOVES}
    if m.CELLS is not None:
        e["workloads"] = list(m.CELLS)
    return e


def benchmark_json(root_repo: Optional[str] = None) -> dict:
    path = os.path.join(root_repo or os.path.dirname(HERE),
                        "BENCHMARK.json")
    with open(path) as f:
        return json.load(f)
