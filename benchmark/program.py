"""The program's own spans in a traced run of a cell: the engine's tracer
(nice_slam_torch/utils/profiling.StageTimer) records from the engine's
construction to the end of the profiled sub-window, and `collect` reads
it against the harness's window:

- `spans`: every recorded span (name, id, parent, thread, host t0 / t1
  and device d0 / d1 in ns on the host clock of torch.profiler, counts);
- `frames`, `events`: the window's frame and event ids, from the
  harness's own track and mapping-event spans;
- `sub`: the profiled sub-window, when the profiler recorded device
  work: its device-idle ms by the innermost program span open on the
  host (`idle_ms`), its frames, and the clock check (`clock_ms`, see
  `clock_ms`).

`READINGS` are the per-layer numbers read from it, and `table` the lines
of the idle by span for standard error.  An engine without a recording
tracer (an older program) gives no program spans, and every reading is
then None.  `attach` is called with the engine once it is built, and
`collect` once the profiled sub-window is done, with the profiler still
held."""

from __future__ import annotations

from typing import Optional

# the spans that only replay CUDA graphs: device idle inside them is not
# the host holding the card back
REPLAY_LOOPS = frozenset({"track.iters", "track.gn", "map.middle",
                          "map.fine", "map.color", "map.iters",
                          "map.coarse.iters", "map.ba_gn"})
OUTSIDE = "(outside any span)"


def attach(eng, record: bool = True) -> bool:
    """Start the engine's recording, where it has one."""
    if not record or not hasattr(getattr(eng, "timer", None),
                                 "start_recording"):
        return False
    from nice_slam_torch.utils.profiling import CAPACITY

    eng.timer.start_recording(CAPACITY)
    return True


def collect(eng, d) -> dict:
    """Stop the recording `attach` started and read it against the
    harness's window and profiled sub-window (`d`, harness.Driver, its
    profiler still held)."""
    from benchmark import harness, trace

    spans = eng.timer.stop_recording()
    out = {"spans": spans,
           "frames": [tag for tag, _ in d.track_spans.pairs],
           "events": [tag for tag, _ in d.map_spans.pairs],
           "dropped": eng.timer.dropped, "sub": None}
    if d.prof is None:
        return out
    dev, cpu = trace._events(d.prof, harness.ANNOTATIONS)
    if dev:
        out["sub"] = {"idle_ms": idle_by_span(spans, dev),
                      "frames": d.prof_end - d.end_idx,
                      "clock_ms": clock_ms(spans, dev, cpu)}
    return out


def device_ms(s: dict) -> float:
    """A span's device time in ms (its host time where the device span
    was not measured: on the CPU, where the host is the device)."""
    if s["d0"] is not None:
        return (s["d1"] - s["d0"]) / 1e6
    return (s["t1"] - s["t0"]) / 1e6


# -- the readings -----------------------------------------------------------

def load_frame_ms(p: Optional[dict]) -> Optional[float]:
    """Mean host duration of `frame.load` (the dataset's read, the
    colour's quantisation and the uploads) over the window's frames."""
    if p is None:
        return None
    frames = set(p["frames"])
    ms = [(s["t1"] - s["t0"]) / 1e6 for s in p["spans"]
          if s["name"] == "frame.load" and s["id"] in frames]
    return sum(ms) / len(ms) if ms else None


def _per_event_ms(p: Optional[dict], name: str) -> Optional[float]:
    """Mean, over the window's events, of the summed device span of the
    event's spans `name`."""
    if p is None:
        return None
    per = {}
    events = set(p["events"])
    for s in p["spans"]:
        if s["name"] == name and s["id"] in events:
            per[s["id"]] = per.get(s["id"], 0.0) + device_ms(s)
    return sum(per.values()) / len(per) if per else None


def map_prepare_ms(p: Optional[dict]) -> Optional[float]:
    """Selection, window, frustum masks and BA's camera mask
    (`map.prepare`, the mapper's and the coarse mapper's) an event."""
    return _per_event_ms(p, "map.prepare")


def coarse_ms(p: Optional[dict]) -> Optional[float]:
    """The coarse mapper (`map.coarse`) an event."""
    return _per_event_ms(p, "map.coarse")


def host_idle_ms(p: Optional[dict]) -> Optional[float]:
    """Device-idle ms a frame of the profiled sub-window inside program
    spans other than the replay loops: the time the host holds the card
    back, by the program's own account."""
    if p is None or not p["sub"]:
        return None
    sub = p["sub"]
    ms = sum(v for name, v in sub["idle_ms"].items()
             if name not in REPLAY_LOOPS and name != OUTSIDE)
    return ms / sub["frames"] if sub["frames"] else None


READINGS = {"load_frame_ms": load_frame_ms,
            "map_prepare_ms": map_prepare_ms, "coarse_ms": coarse_ms,
            "host_idle_ms": host_idle_ms}


# -- the sub-window ---------------------------------------------------------

def _merged(dev) -> list:
    """The union of the device records' intervals, in ns."""
    out = []
    for _, s, e in sorted(dev, key=lambda r: r[1]):
        s, e = s * 1e3, e * 1e3
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_span(spans: list, dev: list) -> dict:
    """Device-idle ms between the first and the last device record (in
    `dev`: (name, start us, end us)), by the innermost span open on the
    host at the time: the deepest, and of two as deep the later started
    (the pipelined engine's two threads)."""
    busy = _merged(dev)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if not gaps:
        return {}
    lo, hi = gaps[0][0], gaps[-1][1]
    by = {s["index"]: s for s in spans}
    depth = {}
    for s in spans:
        k, p = 0, s["parent"]
        while p is not None and p in by:
            k, p = k + 1, by[p]["parent"]
        depth[s["index"]] = k
    live = [s for s in spans if s["t1"] > lo and s["t0"] < hi]
    cuts = sorted({lo, hi} | {t for s in live for t in (s["t0"], s["t1"])
                              if lo < t < hi})
    # the innermost span of each elementary interval between two cuts
    starts = sorted(live, key=lambda s: s["t0"])
    pieces, open_, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(starts) and starts[k]["t0"] <= a:
            open_.append(starts[k])
            k += 1
        open_ = [s for s in open_ if s["t1"] > a]
        top = max(open_, key=lambda s: (depth[s["index"]], s["t0"]),
                  default=None)
        pieces.append((a, b, OUTSIDE if top is None else top["name"]))
    out, i = {}, 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov / 1e6
            j += 1
    return out


def clock_ms(spans: list, dev: list, cpu: list = ()) -> dict:
    """For each `track.iters` span whose device span lies in the
    sub-window, in ms: `start`, the start of the first device record that
    ends after the span's start, less that start (a host late to launch
    the loop's first replay adds to it); `end`, the span's end less the
    end of the last device record that starts before it (the clock alone:
    the loop's host runs ahead of its replays); `launch`, the start of
    the first graph launch the host calls (`cpu`: the profiler's host
    records) from the span's host start on, less that start; `anchor`,
    the span's host start less the host stamp of the anchor that placed
    it."""
    recs = sorted((s * 1e3, e * 1e3) for _, s, e in dev)
    launches = sorted(s * 1e3 for n, s, _ in cpu
                      if n.startswith("cudaGraphLaunch"))
    out = {"start": [], "end": [], "launch": [], "anchor": []}
    if not recs:
        return out
    lo, hi = recs[0][0], recs[-1][1]
    for s in spans:
        if s["name"] != "track.iters" or s["d0"] is None \
                or not lo <= s["d0"] <= s["d1"] <= hi:
            continue
        first = next(r for r in recs if r[1] >= s["d0"])
        last = max(r[1] for r in recs if r[0] <= s["d1"])
        launch = next((t for t in launches if t >= s["t0"]), None)
        out["start"].append((first[0] - s["d0"]) / 1e6)
        out["end"].append((s["d1"] - last) / 1e6)
        out["launch"].append(None if launch is None
                             else (launch - s["t0"]) / 1e6)
        out["anchor"].append((s["t0"] - s["anchor"]) / 1e6)
    return out


def table(program: Optional[dict]) -> list:
    """The lines, for standard error, of the sub-window's device-idle ms
    by innermost program span, and the clock check."""
    if not program or not program["sub"]:
        return []
    sub = program["sub"]
    idle = sub["idle_ms"]
    total = sum(idle.values())
    n = max(sub["frames"], 1)
    lines = [f"program spans: {len(program['spans'])} recorded "
             f"({program['dropped']} dropped); device idle by innermost "
             f"span over the profiled sub-window ({sub['frames']} frames, "
             f"{total:.3f} ms idle):",
             f"  {'span':<20} {'ms':>10} {'ms/frame':>10} {'share':>7}"]
    for name, ms in sorted(idle.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<20} {ms:>10.3f} {ms / n:>10.3f} "
                     f"{100 * ms / max(total, 1e-12):>6.2f}%")
    below = sum(ms for name, ms in idle.items()
                if name not in ("frame", OUTSIDE))
    lines.append(f"  inside a named span below `frame`: "
                 f"{100 * below / max(total, 1e-12):.2f}%")
    clock = sub["clock_ms"]
    if clock["start"]:
        k = max(range(len(clock["start"])), key=clock["start"].__getitem__)
        launch = clock["launch"][k]
        lines.append(
            f"clock: over {len(clock['start'])} track.iters device spans, "
            "the first device record ending after a span's start begins "
            f"{min(clock['start']):.4f} to {max(clock['start']):.4f} ms "
            "after it; the span ends "
            f"{min(clock['end']):.4f} to {max(clock['end']):.4f} ms after "
            "the last record starting before its end; the latest start's "
            "first graph launch comes "
            + ("(none recorded)" if launch is None else f"{launch:.4f} ms")
            + " after the span opens on the host, its anchor "
            f"{clock['anchor'][k]:.4f} ms before, its end "
            f"{clock['end'][k]:.4f} ms")
    return lines
