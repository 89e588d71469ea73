"""Share of the traced slice's device-idle time inside the program's
pipeline.call spans but outside their pipeline.replay: the card idle while
the host prepared a batch (its inputs' copies, the lock, the staging)."""


def read(run):
    from harness.spans import idle_share_in

    return idle_share_in(run, "pipeline.call", outside="pipeline.replay")
