"""Share of the padded frames (batch class x latent bucket) of every batch of
the window that no request asked for."""


def read(run):
    from harness.serve import padding_share

    return padding_share(run)
