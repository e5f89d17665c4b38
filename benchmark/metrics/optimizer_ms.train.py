"""optimizer_ms.train, ms: the host's wall time inside the port's
'unast/train/gen_update' span (the gradient norm, the clip and AdamW:
train/steps.py, train/optim.py), per step of the traced tail: the
host's time for the update, its per-leaf launches and any wait inside
it (the device's time for it is optimizer_device_ms.train)."""


def read(rec):
    span = rec.get("trace", {}).get("spans", {}).get("unast/train/gen_update")
    if not span or span["count"] == 0 or span["host_s"] <= 0.0:
        return None
    return 1e3 * span["host_s"] / span["count"]
