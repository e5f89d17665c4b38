"""Arithmetic the per-layer readers share (benchmark/metrics/*.py)."""

from benchmark.reference import bounds as B

FWD_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_tf32x3_kernel",
               "tf32_split_kernel")
BWD_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_kernel",
               "flash_bwd_f32_delta_kernel", "flash_bwd_f32_kernel")


def kernel_seconds(rec, names):
    """Device seconds of the traced tail's kernels whose name holds one of
    `names`, and their launch count."""
    n, s = 0, 0.0
    for name, (count, sec) in rec["trace"]["kernels"].items():
        if any(k in name for k in names):
            n += count
            s += sec
    return n, s


def flash_roofline(rec, kind):
    """The flash kernels' share of their roofline in the traced tail, %:
    the sum of each recorded call's least time (forward: attention_bound,
    backward: backward_bound, from the call's own shapes, valid keys,
    causality and q_start) over the device time of those kernels. None
    when the tail ran none."""
    calls = rec.get("tail", {}).get("flash", {}).get(kind)
    if not calls or "trace" not in rec:
        return None
    bound = B.attention_bound if kind == "fwd" else B.backward_bound
    least_ms = sum(bound(shape, dtype, lens, causal, q_start)[0]
                   for shape, dtype, _, lens, causal, q_start in calls)
    _, sec = kernel_seconds(rec, FWD_KERNELS if kind == "fwd" else BWD_KERNELS)
    if sec <= 0.0:
        return None
    return 100.0 * least_ms * 1e-3 / sec


def idle_share(rec):
    """1 - the device's busy time over the traced tail's wall, %: an upper
    bound, the profiler's own host work being in the wall."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0.0 or t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
