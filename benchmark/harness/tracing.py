"""The profiled tail of a traced run, reduced to what the per-layer
readers and the result's `breakdown` need.

The profiler records on the host only the record_function ranges (user
scope: the program's 'unast/...' spans and the benchmark's 'bench/...'
ones), not every aten op, so that its own host work stays small; on the
device it records every kernel and copy (CUPTI), each with the host time
of its launch where the trace gives it (the runtime call of the same
correlation id).
"""

import numpy as np

SPAN_PREFIXES = ("unast/", "bench/")
TAIL_SPAN = "bench/tail"
NO_SPAN = "(no span)"


def _union(starts, ends):
    """Merged [start, end) intervals of the given ones, sorted."""
    if len(starts) == 0:
        return np.zeros((0, 2), np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return np.stack([s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])], 1)


def profile_tail(fn, device):
    """Run fn() under the profiler and reduce its events (see the module
    docstring). Returns {'window_s', 'busy_s', 'kernels': {name: [n, s]},
    'spans': {name: {'count', 'host_s', 'device_s'}}, 'device_ops',
    'idle_gaps'}: the ten kernels of most device time and the ten spans
    the host was in during the longest idle time of the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd import profiler as P
    from torch._C._profiler import RecordScope

    config = P.profile(use_device="cuda" if device == "cuda" else None,
                       use_kineto=True)
    activities = config.kineto_activities
    config = config.config()
    P._prepare_profiler(config, activities)
    P._enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    try:
        with P.record_function(TAIL_SPAN):
            fn()
            if device == "cuda":
                torch.cuda.synchronize()
    finally:
        results = P._disable_profiler()

    dev = []           # (start, end, name, correlation id)
    launches = {}      # correlation id -> host time of the launch
    ranges = []        # (start, end, name)
    for e in results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(SPAN_PREFIXES):
                continue
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), name, e.correlation_id()))
        elif name.startswith(SPAN_PREFIXES):
            s = e.start_ns()
            ranges.append((s, s + e.duration_ns(), name))
        elif name.startswith("cuda") and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    tail = [r for r in ranges if r[2] == TAIL_SPAN]
    a, b = (tail[0][0], tail[0][1]) if tail else (0, 0)
    starts = np.array([d[0] for d in dev], np.int64)
    ends = np.array([d[1] for d in dev], np.int64)
    busy = _union(starts, ends)
    busy_ns = int((np.minimum(busy[:, 1], b) - np.maximum(busy[:, 0], a))
                  .clip(min=0).sum()) if len(busy) else 0

    inner = sorted((r for r in ranges if r[2] != TAIL_SPAN),
                   key=lambda r: r[0])
    names = [r[2] for r in inner] + [NO_SPAN]

    def owners(times):
        # per host time, the index in `inner` of the innermost span that
        # holds it (the latest to start), -1 for none: later spans
        # overwrite earlier ones over the times they cover
        order = np.argsort(times, kind="stable")
        st = times[order]
        own = np.full(len(times), -1, np.int64)
        for i, (s, e, _) in enumerate(inner):
            own[np.searchsorted(st, s, "left"):np.searchsorted(st, e, "right")] = i
        out = np.empty_like(own)
        out[order] = own
        return out

    kernels, spans = {}, {}
    for s, e, name in inner:
        rec = spans.setdefault(name, {"count": 0, "host_s": 0.0,
                                      "device_s": 0.0})
        rec["count"] += 1
        rec["host_s"] += (e - s) * 1e-9
    launch = np.array([launches.get(d[3], d[0]) for d in dev], np.int64)
    for (s, e, name, _), o in zip(dev, owners(launch)):
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
        if o >= 0:
            spans[names[o]]["device_s"] += (e - s) * 1e-9

    edges = np.concatenate([[a], busy.reshape(-1), [b]]).astype(np.int64)
    g0 = np.maximum(edges[0::2], a)
    g1 = np.minimum(edges[1::2], b)
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    gaps = {}
    for o, dur in zip(owners(g0), (g1 - g0) * 1e-9):
        gaps[names[o]] = gaps.get(names[o], 0.0) + float(dur)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_s": (b - a) * 1e-9, "busy_s": busy_ns * 1e-9,
            "kernels": kernels, "spans": spans,
            "device_ops": [[n[:160], s_] for n, (_, s_) in top],
            "idle_gaps": [[n, s_] for n, s_ in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}

