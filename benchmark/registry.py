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
  unit, layer, source, the end-to-end metric it moves, its cells and,
  where it reads only some modes' work, its MODES;
- benchmark/modes/<mode>.py: how a configuration of one mode (`mode_of`:
  NICE or iMAP*) is checked and costed: the iterations of a mapping event
  whose state the check reads, the start gap, the judge and the least
  time of the window's schedule.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = ("NAME", "UNIT", "BETTER", "SOURCE", "LAYER", "MOVES", "CELLS")
MODE_KEYS = ("STATE_GRIDS", "snapshot_iterations", "start_gap", "judge",
             "schedule_least_ms")


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
    """Every name of a kind ('workloads', 'configs', 'traffic', 'metrics'
    or 'modes') that has a file."""
    ext = ".py" if kind in ("metrics", "modes") else ".json"
    d = os.path.join(root, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def _load(kind: str, name: str, keys, root: str = HERE) -> ModuleType:
    """The module benchmark/<kind>/<name>.py, which must define `keys`."""
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind[:-1]}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in keys if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"{kind[:-1]} file {path}: missing {missing}")
    return mod


def metric(name: str, root: str = HERE) -> ModuleType:
    mod = _load("metrics", name, KEYS + ("read",), root)
    if mod.NAME != name:
        raise ValueError(f"metric file of {name!r} names {mod.NAME!r}")
    return mod


def mode_of(cfg: dict) -> str:
    """A frozen `cfg`'s mode: 'nice' (the hierarchical grids and their
    decoders) or 'imap' (iMAP*'s one MLP, `nice: false`)."""
    return "nice" if cfg["nice"] else "imap"


def mode(name: str, root: str = HERE) -> ModuleType:
    """The module of a mode, benchmark/modes/<name>.py."""
    return _load("modes", name, MODE_KEYS, root)


def cell_mode(cell: str, root: str = HERE) -> str:
    """The mode of a cell's configuration, from their files."""
    return mode_of(config(workload(cell, root)["config"], root)["cfg"])


def modes_of(m: ModuleType) -> Optional[tuple]:
    """The modes whose cells a metric reads (None: every mode)."""
    return getattr(m, "MODES", None)


def metrics_for(cell: str, root: str = HERE,
                mode: Optional[str] = None) -> Dict[str, ModuleType]:
    """The per-layer metrics whose CELLS hold `cell` (None: every cell)
    and whose MODES, where a metric gives them, hold the cell's mode
    (`mode`, or that of the cell's configuration file)."""
    out = {}
    for n in names("metrics", root):
        m = metric(n, root)
        if m.CELLS is not None and cell not in m.CELLS:
            continue
        if modes_of(m) is not None:
            if (mode or cell_mode(cell, root)) not in modes_of(m):
                continue
        out[n] = m
    return out


def per_layer_entry(m: ModuleType, root_repo: Optional[str] = None) -> dict:
    """The metric's BENCHMARK.json entry: its `workloads` are its CELLS,
    or, for a metric of some MODES, the BENCHMARK.json cells of those
    modes."""
    e = {"name": m.NAME, "unit": m.UNIT, "better": m.BETTER,
         "source": m.SOURCE, "layer": m.LAYER, "moves": m.MOVES}
    cells = m.CELLS
    if modes_of(m) is not None:
        root = os.path.join(root_repo, "benchmark") if root_repo else HERE
        cells = [w["name"] for w in benchmark_json(root_repo)["workloads"]
                 if (m.CELLS is None or w["name"] in m.CELLS)
                 and cell_mode(w["name"], root) in modes_of(m)]
    if cells is not None:
        e["workloads"] = list(cells)
    return e


def benchmark_json(root_repo: Optional[str] = None) -> dict:
    path = os.path.join(root_repo or os.path.dirname(HERE),
                        "BENCHMARK.json")
    with open(path) as f:
        return json.load(f)
