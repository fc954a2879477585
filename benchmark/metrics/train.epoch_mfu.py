"""train.epoch_mfu: the epoch's forward and backward operations, counted
from shapes (``counts.epoch_flops``), over the window's time per epoch
times the float32 peak (67 TFLOP/s: the port runs its products in float32
with TF32 off), in %."""

from benchmark import counts


def read(run):
    if not run["sizes"] or run["devices"][0]["busy_s"] <= 0:
        return None
    flops = counts.epoch_flops(run["sizes"], run["model"], run["train"],
                               run["steps"]["cf"], run["steps"]["kg"])
    epoch_s = run["window"]["seconds"] / run["window"]["epochs"]
    return 100.0 * flops / epoch_s / counts.F32_FLOPS
