"""Median of every request due in the window, from its due time to its waveform
on the host; a failed request counts as slower than any."""


def read(run):
    from harness.serve import latency_percentile

    return latency_percentile(run, 50)
