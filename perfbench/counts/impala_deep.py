"""FLOPs of one forward pass of the IMPALA deep ResNet on one frame
(2 a multiply-add; convolutions at "same" padding, stride 1; max-pools,
ReLUs and additions not counted): the model FLOPs ``mfu`` reads.

At Atari's 84 x 84 x 4, 18 actions: 108,455,424 a frame."""

from __future__ import annotations


def forward_flops(agent: dict) -> float:
    h, w, cin = agent["obs_shape"]
    flops = 0
    for ch in agent["channels"]:
        flops += 2 * 9 * cin * ch * h * w                 # the section conv
        h, w = -(-h // 2), -(-w // 2)                     # 3x3/2 max-pool
        flops += agent["residual_blocks"] * 2 * (2 * 9 * ch * ch * h * w)
        cin = ch
    flat = h * w * cin
    flops += 2 * flat * agent["fc"]
    flops += 2 * agent["fc"] * (agent["num_actions"] + 1)
    return float(flops)
