"""Analytic FLOPs of the answers that reached the host in the window, each at
its own lengths (conditioning, the denoiser's steps, the codec decode), over
the window, as a share of 989 TFLOP/s."""


def read(run):
    from harness import flops
    from harness.serve import completed_in_window

    done = completed_in_window(run)
    if not done:
        return None
    steps = run.cell.config["serving"]["num_steps"]
    total = sum(flops.request_flops(run.model, len(s.req.ref), len(s.req.phonemes), s.req.seq_len,
                                    steps) for s in done)
    return 100.0 * total / run.window_s / flops.PEAK_FLOPS
