"""``k3_decode_roofline.lm``: the decode-attention kernel's share of its
roofline over the profiled stretch: the least time of the calls a step
makes (the family's ``k3_calls``: valid slots and count of each, counted
by ``counts/decode_attention.py``, valid slots only, against
``peaks.py``) times the stretch's steps, over the device time of the
kernel's launches (its split launch and its merge). Nothing is read where
the split launches the profiler saw are not the calls the steps make."""

from perfbench import peaks, trace
from perfbench.counts import decode_attention


def read(run):
    if run.profile is None:
        return None
    _, calls = trace.kernel_time(run.profile, "decode_attention_kernel")
    seconds, _ = trace.kernel_time(run.profile, "decode_attention_kernel",
                                   "decode_combine_kernel")
    per_step = run.setup.k3_calls()
    steps = run.profile["steps"]
    if not calls or seconds <= 0 \
            or calls != steps * sum(n for n, _ in per_step):
        return None
    bound = 0.0
    for n, dims in per_step:
        dims = dict(dims)
        dtype = dims.pop("dtype")
        flops, nbytes = decode_attention.launch(**dims)
        bound += n * peaks.bound_s(flops, nbytes, dtype)
    return 100.0 * steps * bound / seconds
