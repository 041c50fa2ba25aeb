"""Decoded message bits of every request completed in the window, over
the window's length (host clock), in Mbit/s."""


def read(ctx):
    return ctx.window.bits / ctx.window.seconds / 1e6
