"""Process start to the first timed call (host clock): imports, device
start-up, traffic made on the device, compile-cache hits and warm-up of
the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
