"""Paper-faithful IMPALA agent networks as ``nn.Module``s.

``impala_deep``: the IMPALA "deep" ResNet (15 conv layers: 3 sections of
conv + maxpool + 2 residual blocks; FC 256; policy + baseline heads) — the
network TorchBeast trains on Atari (§4, without LSTM).

``minatar_net``: the small ConvNet of the paper's MinAtar adaptation example
(Fig. 2): conv3x3x16 + FC 128 + heads.

``minatar_lstm_net``: the same torso with an LSTM core, TorchBeast's
recurrent agent (``use_lstm``): ``model(obs, core_state, done)`` takes one
time step and returns a ``RecurrentAgentOutput`` with the new core state.

``model(obs) -> AgentOutput``. Obs is (..., H, W, C) float32 (the JAX
layout); leading dims are flattened and restored so (T, B, ...) learner
batches work directly. Convolutions run in NCHW; the activations go back
to NHWC before the flatten that feeds the FC layer, so the FC weights keep
the reference's (h, w, c) row order.

Init matches the reference's distribution: truncated normal on ±2σ scaled
by 1/sqrt(fan_in) (kh*kw*cin for a conv, din for a linear layer), heads
scaled 0.01, biases zero. Weights come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn


class AgentOutput(NamedTuple):
    policy_logits: torch.Tensor  # (..., num_actions)
    baseline: torch.Tensor       # (...,)


class RecurrentAgentOutput(NamedTuple):
    policy_logits: torch.Tensor
    baseline: torch.Tensor
    core_state: tuple            # (h, c) LSTM state, threaded by the actor


def _init_(layer, fan_in: int, gen: torch.Generator, scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, 1.0, -2.0, 2.0,
                              generator=gen)
        layer.weight.mul_(scale)
        layer.bias.zero_()
    return layer


def _conv(cin, cout, gen, padding=1):
    """3x3 stride-1 conv; padding=1 is the reference's "SAME"."""
    return _init_(nn.Conv2d(cin, cout, 3, padding=padding), 9 * cin, gen)


def _linear(din, dout, gen, scale=None):
    return _init_(nn.Linear(din, dout), din, gen, scale)


def _nhwc_flat(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _heads(model, x, lead):
    logits = model.policy(x)
    baseline = model.baseline(x)[..., 0]
    return AgentOutput(logits.reshape(lead + (logits.shape[-1],)),
                       baseline.reshape(lead))


def _nchw(obs):
    lead = obs.shape[:-3]
    x = obs.reshape((-1,) + obs.shape[-3:]).float()
    return x.permute(0, 3, 1, 2), tuple(lead)


class _ResBlock(nn.Module):
    def __init__(self, ch, gen):
        super().__init__()
        self.c1 = _conv(ch, ch, gen)
        self.c2 = _conv(ch, ch, gen)

    def forward(self, x):
        return x + self.c2(F.relu(self.c1(F.relu(x))))


class _Section(nn.Module):
    def __init__(self, cin, ch, gen):
        super().__init__()
        self.conv = _conv(cin, ch, gen)
        self.res = nn.ModuleList([_ResBlock(ch, gen), _ResBlock(ch, gen)])

    def forward(self, x):
        # window 3, stride 2, pad 1; PyTorch pads max-pooling with -inf
        x = F.max_pool2d(self.conv(x), 3, 2, padding=1)
        for block in self.res:
            x = block(x)
        return x


class ImpalaDeep(nn.Module):
    def __init__(self, obs_shape, num_actions, channels=(16, 32, 32),
                 fc=256, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        h, w, cin = obs_shape
        sections = []
        for ch in channels:
            sections.append(_Section(cin, ch, gen))
            cin = ch
            h, w = -(-h // 2), -(-w // 2)
        self.sections = nn.ModuleList(sections)
        self.fc = _linear(h * w * channels[-1], fc, gen)
        self.policy = _linear(fc, num_actions, gen, scale=0.01)
        self.baseline = _linear(fc, 1, gen, scale=0.01)

    def forward(self, obs) -> AgentOutput:
        x, lead = _nchw(obs)
        for sec in self.sections:
            x = sec(x)
        x = F.relu(self.fc(_nhwc_flat(F.relu(x))))
        return _heads(self, x, lead)


class MinatarNet(nn.Module):
    def __init__(self, obs_shape, num_actions, conv_ch=16, fc=128, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        h, w, cin = obs_shape
        self.conv = _conv(cin, conv_ch, gen, padding=0)   # "VALID"
        self.core = _linear((h - 2) * (w - 2) * conv_ch, fc, gen)
        self.policy = _linear(fc, num_actions, gen, scale=0.01)
        self.baseline = _linear(fc, 1, gen, scale=0.01)

    def forward(self, obs) -> AgentOutput:
        x, lead = _nchw(obs)
        y = F.relu(self.core(_nhwc_flat(F.relu(self.conv(x)))))
        return _heads(self, y, lead)


class MinatarLSTMNet(nn.Module):
    """MinAtar ConvNet torso + LSTM core. ``forward(obs, core_state,
    done)`` takes a single step, obs (B, H, W, C); where ``done`` is set
    the state rows are zeroed before the cell (TorchBeast's reset at
    episode ends).

    The cell is written out as the reference's: gates from two linears,
    ``lstm_x`` on the torso output and ``lstm_h`` on h, split i, f, g, o,
    with a forget bias of +1.0. ``torch.nn.LSTMCell`` has no forget bias,
    so it computes another function."""

    def __init__(self, obs_shape, num_actions, conv_ch=16, core=128, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        h, w, cin = obs_shape
        self.core_size = core
        self.conv = _conv(cin, conv_ch, gen, padding=0)   # "VALID"
        self.torso = _linear((h - 2) * (w - 2) * conv_ch, core, gen)
        self.lstm_x = _linear(core, 4 * core, gen, scale=core ** -0.5)
        self.lstm_h = _linear(core, 4 * core, gen, scale=core ** -0.5)
        self.policy = _linear(core, num_actions, gen, scale=0.01)
        self.baseline = _linear(core, 1, gen, scale=0.01)

    def initial_state(self, batch):
        z = torch.zeros((batch, self.core_size),
                        device=self.torso.weight.device)
        return (z, z)

    def features(self, obs):
        """The torso's output, (..., core), for obs (..., H, W, C): it
        carries no state, so the learner runs it once over a whole
        unroll."""
        x, lead = _nchw(obs)
        y = F.relu(self.torso(_nhwc_flat(F.relu(self.conv(x)))))
        return y.reshape(lead + (self.core_size,))

    def cell(self, y, core_state, done=None) -> RecurrentAgentOutput:
        """One LSTM step on torso features ``y`` (B, core), then the
        heads."""
        hs, cs = core_state
        if done is not None:
            keep = (~done)[:, None].to(hs.dtype)
            hs, cs = hs * keep, cs * keep
        i, f, g, o = torch.chunk(self.lstm_x(y) + self.lstm_h(hs), 4,
                                 dim=-1)
        cs = torch.sigmoid(f + 1.0) * cs + torch.sigmoid(i) * torch.tanh(g)
        hs = torch.sigmoid(o) * torch.tanh(cs)
        return RecurrentAgentOutput(self.policy(hs),
                                    self.baseline(hs)[..., 0], (hs, cs))

    def forward(self, obs, core_state, done=None) -> RecurrentAgentOutput:
        return self.cell(self.features(obs), core_state, done)


# The reference's names for the agents.
impala_deep = ImpalaDeep
minatar_net = MinatarNet
minatar_lstm_net = MinatarLSTMNet
