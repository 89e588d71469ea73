"""Device ms a step of the foreach (multi_tensor_apply) kernels of AdamW and
the EMA, over the traced steps."""


def read(run):
    from harness.trace import kernel_class

    prof = run.profile
    if prof is None or not getattr(prof, "steps", 0):
        return None
    ns = sum(r.end - r.start for r in prof.records if kernel_class(r.name) == "optimizer")
    return ns / 1e6 / prof.steps if ns else None
