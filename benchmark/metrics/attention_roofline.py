"""Sum of every attention launch's bound (style, text, DiT; the keys each row's
masks leave live) over their device time."""


def read(run):
    from harness.serve import roofline

    return roofline(run, "attention")
