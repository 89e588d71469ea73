"""Analytic FLOPs of each step of the window, forward and backward at the
batch's true lengths, over the window, as a share of 989 TFLOP/s."""


def read(run):
    from harness import flops

    if not run.steps:
        return None
    return 100.0 * sum(s.flops for s in run.steps) / run.window_s / flops.PEAK_FLOPS
