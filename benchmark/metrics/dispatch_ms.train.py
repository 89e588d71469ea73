"""Host ms until step() returns (it does not wait for the device), the mean
over the window's steps."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * sum(s.dispatch_s for s in run.steps) / len(run.steps)
