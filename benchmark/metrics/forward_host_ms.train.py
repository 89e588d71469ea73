"""Host ms a traced teacher step spends in its teacher.forward span (the
program's own)."""


def read(run):
    from harness.spans import per_step_ms

    return per_step_ms(run, "teacher.forward")
