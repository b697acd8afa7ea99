"""Reading the profiled sub-window: device time by kernel name, the union
of the device intervals (busy seconds), and the longest idle gaps,
labelled by the host operation that was running then."""

from __future__ import annotations


def _events(prof, annotations=()):
    """(device, cpu) lists of (name, start_us, end_us) from the
    profiler's raw records.  The profiler mirrors each host annotation
    (`record_function`) onto the device's timeline; those are no device
    work and are left out of the device list."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            s, d = e.start_us(), e.duration_us()
        rec = (e.name(), s, s + d)
        if e.device_type() == DeviceType.CUDA:
            if rec[0] not in annotations:
                dev.append(rec)
        elif e.device_type() == DeviceType.CPU and d > 0:
            cpu.append(rec)
    return dev, cpu


def summarize(prof, window_s: float, annotations=(), top: int = 10) -> dict:
    dev, cpu = _events(prof, annotations)
    by_name = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ivs = sorted((s, e) for _, s, e in dev)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])
    cpu.sort(key=lambda r: r[1])
    labelled = []
    for g0, g1 in gaps[:top]:
        # the shortest host operation that covers most of the gap
        best = None
        for n, s, e in cpu:
            if s > g1:
                break
            cover = min(e, g1) - max(s, g0)
            if cover >= 0.5 * (g1 - g0) and (
                    best is None or e - s < best[1]):
                best = (n, e - s)
        labelled.append([best[0] if best else "host, outside any operation",
                         (g1 - g0) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"kernel_s": by_name, "busy_s": busy / 1e6, "window_s": window_s,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": labelled}
