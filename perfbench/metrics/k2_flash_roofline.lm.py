"""``k2_flash_roofline.lm``: the flash-attention kernel's share of its
roofline over the profiled stretch: the least time of the launches a
step makes (the family's ``k2_launches``: shape and count of each,
counted by ``counts/flash_attention.py`` against ``peaks.py``) times the
stretch's steps, over the device time the profiler gives the kernel's
launches. Nothing is read where the launches the profiler saw are not
those the steps make."""

from perfbench import peaks, trace
from perfbench.counts import flash_attention


def read(run):
    if run.profile is None:
        return None
    seconds, launches = trace.kernel_time(run.profile, "flash_tc_kernel",
                                          "flash_attention_kernel")
    per_step = run.setup.k2_launches()
    steps = run.profile["steps"]
    if not launches or seconds <= 0 \
            or launches != steps * sum(n for n, _ in per_step):
        return None
    bound = 0.0
    for n, dims in per_step:
        dims = dict(dims)
        dtype = dims.pop("dtype")
        flops, nbytes = flash_attention.launch(**dims)
        bound += n * peaks.bound_s(flops, nbytes, dtype)
    return 100.0 * steps * bound / seconds
