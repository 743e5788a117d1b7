"""The step's model work (the detector forward over the F x K crops and,
distilling, the head update) over the mean step time of the timed
window, as a share of the H100's dense TF32 rate, %. Read in the traced
run, where the profiled stretch shows the device worked."""
from bench.harness.costs import PEAK_TF32_FLOPS, step_model_flops


def read(ctx):
    if not ctx.get("busy_s"):
        return None
    w = ctx["window"]
    mean_step_s = w.seconds / w.steps
    return 100.0 * step_model_flops(ctx["dims"]) / (mean_step_s
                                                    * PEAK_TF32_FLOPS)
