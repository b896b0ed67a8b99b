"""Host microseconds a frame spends in ``Simulation.step_frame`` (the host
clock around the call, no sync), the mean over the untraced frames of the
window."""


def read(ctx):
    enq = ctx.window.enqueue[ctx.window.untraced_from:]
    return 1e6 * sum(enq) / len(enq) if enq else None
