"""Sum of the codec convolutions' bounds, fp32 held to the bf16 peak, over
their device time."""


def read(run):
    from harness.serve import roofline

    return roofline(run, "codec_conv")
