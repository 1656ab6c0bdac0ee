"""``mfu.lm``: the model's FLOPs a step (the family's
``model_flops_per_step``: forward plus twice for the backward, nothing
recomputed counted) times the traced window's steps, over its seconds,
over the card's float32 peak (67 TFLOP/s, ``peaks.py``): float32 outside
the tensor cores is the precision the program pins."""

from perfbench import peaks


def read(run):
    if run.window_s <= 0:
        return None
    flops = run.setup.model_flops_per_step() * run.window_steps
    return 100.0 * flops / run.window_s / peaks.FLOPS["float32"]
