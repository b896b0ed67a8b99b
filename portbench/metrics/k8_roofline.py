"""K8's share of its roofline, in % (``harness.Context.roofline``)."""


def read(ctx):
    return ctx.roofline("K8")
