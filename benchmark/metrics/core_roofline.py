"""The decoder core's share of its roofline, in %: the least time the
chips need for the work the decode requires (`harness/work.py`, from
shapes alone), over the device time of the core's kernels per request,
averaged over the chips used.  The bound that applies is printed."""

from benchmark.harness import peaks
from benchmark.harness.trace import name_matcher

#: The kernels whose time the work is set against; re-point them if the
#: core is renamed, split or fused.
KERNELS = ("viterbi_acs_forward", "viterbi_traceback")


def read(ctx):
    tr, match = ctx.trace, name_matcher(KERNELS)
    if ctx.work is None or not any(tr.op_count(d, match) for d in tr.devices):
        return None
    per_request = (sum(tr.op_ns(d, match) for d in tr.devices)
                   / len(tr.devices) / ctx.window.requests * 1e-9)
    least, bound = peaks.least_seconds(ctx.work["ops"], ctx.work["bytes"],
                                       ctx.device_kind, ctx.chips)
    ctx.notes.append(
        f"core_roofline: {bound}-bound, least {least * 1e6:.3f} us for "
        f"{ctx.work['ops']} ops and {ctx.work['bytes']} bytes per request "
        f"on {ctx.chips} x {ctx.device_kind}; core {per_request * 1e6:.3f} us")
    return 100.0 * least / per_request
