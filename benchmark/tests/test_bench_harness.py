"""The harness on the CPU: files found by name, a dropped-in cell or
metric picked up with no other file edited, the result line's keys, no
fall-back to the CPU, no JAX, a reference that imports nothing of the
program, and BENCHMARK.json in step with the files."""

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark import registry, run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


def test_every_file_is_found_by_name():
    for cell in registry.names("workloads"):
        wl = registry.workload(cell)
        registry.config(wl["config"])
        registry.traffic(wl["traffic"])
    for name in registry.names("metrics"):
        m = registry.metric(name)
        assert m.NAME == name


def test_a_dropped_in_cell_and_metric_are_picked_up(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (root / "workloads" / "room0.extra.json").write_text(json.dumps(
        dict(registry.workload("room0.strict"), why="a new cell")))
    (root / "metrics" / "extra_ms.py").write_text(
        'NAME = "extra_ms"\nUNIT = "ms"\nBETTER = "lower"\n'
        'SOURCE = "program_span"\nLAYER = "tracking"\n'
        'MOVES = "frames_per_s"\nCELLS = ["room0.extra"]\n'
        'def read(ctx):\n    return 1.0\n')
    assert "room0.extra" in registry.names("workloads", str(root))
    assert registry.workload("room0.extra", str(root))["why"] == "a new cell"
    got = registry.metrics_for("room0.extra", str(root))
    assert "extra_ms" in got and "track_ms" in got
    assert "extra_ms" not in registry.metrics_for("room0.strict", str(root))


def test_a_deployment_config_is_its_base_with_its_set():
    """The pipelined deployment holds no copy of room0's published keys:
    its file names its base and the one key it sets."""
    base = registry.config("replica_room0")
    dep = registry.config("replica_room0_pipelined")
    assert dep["name"] == "replica_room0_pipelined"
    assert dep["cfg"]["tpu"]["pipelined"] and not base["cfg"]["tpu"][
        "pipelined"]
    dep["cfg"]["tpu"]["pipelined"] = False
    assert dep["cfg"] == base["cfg"]
    raw = json.load(open(os.path.join(BENCH, "configs",
                                      "replica_room0_pipelined.json")))
    assert "cfg" not in raw and raw["set"] == {"tpu.pipelined": True}


def test_the_check_follows_every_stage():
    """At room0's published 60 iterations the check follows the first
    two steps of the middle, fine and colour stages, and each stage's
    fresh groups: the colour stage's decoder, grid and, under BA, the
    window cameras."""
    from benchmark.reference import follow

    cfg = registry.config("replica_room0")["cfg"]
    assert follow.stage_plan(cfg) == [("middle", 0, 25), ("fine", 25, 12),
                                      ("color", 37, 23)]
    assert [(s, it) for s, it, _ in follow.followed_steps(cfg)] == [
        ("middle", 0), ("middle", 1), ("fine", 25), ("fine", 26),
        ("color", 37), ("color", 38)]
    assert follow.snapshot_iterations(cfg) == [0, 1, 2, 25, 26, 27, 37, 38,
                                               39]
    assert follow.fresh_groups(cfg, ba=True) == {
        "middle": ["grid/middle"], "fine": ["grid/fine"],
        "color": ["grid/color", "decoder/color", "cams"]}
    assert "cams" not in follow.fresh_groups(cfg, ba=False)["color"]


def test_result_line_has_the_contract_keys(sound_run):
    res, lines = sound_run
    assert set(res) == KEYS
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p90",
                                   "peak_mem_mib", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    for k, v in res["check"].items():
        assert set(v) == {"value", "limit"}
        assert any(line.startswith(f"check {k}:") for line in lines)
    json.dumps(res)


def test_traced_result_has_the_per_layer_metrics():
    from benchmark.tests.conftest import small_run

    res, _ = small_run(trace=1, seed=12)
    assert set(res) == KEYS | {"breakdown"}
    want = set(registry.metrics_for("room0.strict"))
    # the trace-read metrics need a card; the spans and counters do not
    assert {"track_ms", "map_event_ms", "first_event_s", "step_mfu"} <= \
        set(res["metrics"]) <= want
    assert res["correct"]


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "benchmark", "run.py"),
         "--workload", "room0.strict", "--seed", "5", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    p = _run_py(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _run_py(str(tmp_path))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_jax_in_a_run():
    """A whole CPU run of the harness (cell, program, reference) in a
    fresh interpreter loads no module whose top-level name is jax, jaxlib,
    flax or nice_slam_tpu."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests.conftest import small_run\n"
        "from benchmark import run\n"
        "res, _ = small_run(seconds=0.5)\n"
        "print('FORBIDDEN', run.forbidden_modules())\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FORBIDDEN []" in p.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "nice_slam_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like.sub", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nice_slam_tpu.engine", sys)
    assert run.forbidden_modules() == ["nice_slam_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert not tops & {"nice_slam_torch", "nice_slam_tpu", "jax",
                               "jaxlib", "flax"}, f


def test_benchmark_json_matches_the_files():
    bj = registry.benchmark_json()
    assert bj["paths"] == ["benchmark"]
    assert bj["command"] == ["python3", "benchmark/run.py"]
    for c in bj["configs"]:
        conf = registry.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["source"] == conf["source"]
        assert c["reduced"] == conf["reduced"]
    cells = {w["name"]: w for w in bj["workloads"]}
    assert set(cells) <= set(registry.names("workloads"))
    pairs = set()
    for name, w in cells.items():
        wl = registry.workload(name)
        assert (w["config"], w["traffic"], w["chips"]) == (
            wl["config"], wl["traffic"], wl["chips"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {c["name"] for c in bj["configs"]} == {
        w["config"] for w in cells.values()}
    per_layer = {m["name"]: m for m in bj["per_layer"]}
    for name, entry in per_layer.items():
        assert entry == registry.per_layer_entry(registry.metric(name))
    # a metric file that BENCHMARK.json leaves out reads no listed cell
    for name in set(registry.names("metrics")) - set(per_layer):
        cells_of = registry.metric(name).CELLS
        assert cells_of is not None and not set(cells_of) & set(cells)
