"""Device time per request of the decoder core's forward kernel, in us,
averaged over the chips used (profiler trace)."""

from benchmark.harness.trace import name_matcher

#: The kernels this metric sums; re-point them if the core is renamed.
KERNELS = ("viterbi_acs_forward",)


def read(ctx):
    tr, match = ctx.trace, name_matcher(KERNELS)
    if not any(tr.op_count(d, match) for d in tr.devices):
        return None
    ns = sum(tr.op_ns(d, match) for d in tr.devices) / len(tr.devices)
    return ns / ctx.window.requests / 1e3
