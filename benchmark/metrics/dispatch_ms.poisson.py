"""Host ms inside each synthesize_padded(fetch=False) call the batcher made in
the window, the mean over the calls."""


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(b.host_s for b in run.batches) / len(run.batches)
