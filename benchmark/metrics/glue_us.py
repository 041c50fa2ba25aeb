"""Device time per request of every device operation other than the
decoder core's kernels (transposes, depuncture, byte packing, copies),
in us, averaged over the chips used (profiler trace)."""

from benchmark.harness.trace import name_matcher

#: The core's kernels, left out here; re-point them if the core is renamed.
CORE = ("viterbi_acs_forward", "viterbi_traceback")


def read(ctx):
    tr, core = ctx.trace, name_matcher(CORE)
    glue = sum(tr.op_ns(d, lambda n: not core(n)) for d in tr.devices)
    if not any(tr.op_count(d) for d in tr.devices):
        return None
    return glue / len(tr.devices) / ctx.window.requests / 1e3
