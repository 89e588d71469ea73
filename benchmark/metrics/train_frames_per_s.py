"""True (unpadded) latent frames of every step completed in the window, over
the window."""


def read(run):
    return sum(s.frames for s in run.steps) / run.window_s if run.steps else None
