"""Share of the traced window in which no operation ran on the device, in
%, averaged over the chips used: 1 - (union of busy intervals) / window."""


def read(ctx):
    return 100.0 * ctx.trace.idle_share()
