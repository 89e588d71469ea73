"""Share of the traced steps' slice in which the device ran nothing."""


def read(run):
    prof = run.profile
    if prof is None:
        return None
    return 100.0 * (1.0 - prof.busy_s(clip=False) / prof.window_s)
