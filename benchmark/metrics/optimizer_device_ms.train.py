"""optimizer_device_ms.train, ms: the device time of the kernels launched
inside the port's 'unast/train/gen_update' span (the gradient norm, the
clip and AdamW: train/steps.py, train/optim.py), per step of the traced
tail. A kernel counts where the host launched it."""


def read(rec):
    span = rec.get("trace", {}).get("spans", {}).get("unast/train/gen_update")
    if not span or span["count"] == 0 or span["device_s"] <= 0.0:
        return None
    return 1e3 * span["device_s"] / span["count"]
