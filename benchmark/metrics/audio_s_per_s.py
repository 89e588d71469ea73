"""Audio seconds the answers that reached the host in the window asked for
(their own lengths, not their buckets), over the window."""


def read(run):
    from harness.serve import completed_in_window

    done = completed_in_window(run)
    return sum(s.req.audio_s for s in done) / run.window_s if done else None
