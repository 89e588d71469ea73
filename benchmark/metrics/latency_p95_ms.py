"""95th percentile of the same."""


def read(run):
    from harness.serve import latency_percentile

    return latency_percentile(run, 95)
