"""The one generator of traffic: a mix is a JSON file of parameters
(``traffic/<mix>.json``) whose ``kind`` names the module that builds its
feed, ``traffic/kinds/<kind>.py``, found by that name as a per-layer
metric's reader is. A new kind of traffic is a new file there.

A kind's ``make(traffic, *, seed, device, **ctx)`` builds, from the run's
seed, the source the window drives and what the check needs of the
traffic (``Feed``); ``ctx`` holds what the family has built for it
(``agent``, ``obs_shape``, ``num_actions``, ``model_cfg``), each kind
taking what it needs.
"""

from __future__ import annotations

import importlib
from typing import Any, NamedTuple, Optional


class Feed(NamedTuple):
    source: Any
    bank: Optional[Any] = None      # the Atari environment's frame bank
    actor_lag: int = 0              # params steps the actors lag behind


def make_source(traffic: dict, *, seed: int, device, **ctx) -> Feed:
    kind = importlib.import_module("perfbench.traffic.kinds."
                                   + traffic["kind"])
    return kind.make(traffic, seed=seed, device=device, **ctx)
