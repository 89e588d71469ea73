"""Sum of the scan launches' bounds (989 TFLOP/s, 3.35 TB/s; launched shapes)
over their device time, over the same batches."""


def read(run):
    from harness.serve import roofline

    return roofline(run, "scan")
