"""Share of the traced slice in which the device ran nothing: 1 - the union of
its kernel, copy and set intervals over the slice."""


def read(run):
    from harness.serve import idle_share

    return idle_share(run)
