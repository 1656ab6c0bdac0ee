"""``k1_vtrace_roofline.atari``: the V-trace kernel's share of its
roofline: the least time its launches in the profiled stretch could take
(``counts/vtrace.py`` at the learner's (T, B), against ``peaks.py``)
over the device time the profiler gives them."""

from perfbench import peaks, trace
from perfbench.counts import vtrace


def read(run):
    if run.profile is None:
        return None
    seconds, launches = trace.kernel_time(run.profile, "vtrace")
    if not launches or seconds <= 0:
        return None
    flops, nbytes = vtrace.launch(*run.setup.vtrace_shape())
    bound = peaks.bound_s(flops, nbytes, "float32")
    return 100.0 * launches * bound / seconds
