"""The dry run's choice of rules, after the reference's
``launch/dryrun.py``.

Only ``resolve_rules`` (``--rules auto``) is ported: ``launch/multihost.py``
and the ``specs`` programs use it. The rest of the reference's module
compiles each program with XLA and reads its memory, cost and collective
analyses (``collective_bytes``, ``_analyze``, ``run_one``, ``main``);
its counterpart for the port waits for ROADMAP item 22.
"""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES


def resolve_rules(rules_name: str, shape_name: str, arch: str) -> str:
    """The rules table for ``--rules``; ``auto`` is the reference's
    baseline: training keeps the residual stream sequence-parallel, with
    FSDP weights from 8B parameters; serving is Megatron, FSDP from 60B;
    an MoE whose expert count divides 16 runs expert-parallel."""
    if rules_name != "auto":
        return rules_name
    cfg = get_config(arch)
    n = cfg.param_count()
    ep = cfg.num_experts and cfg.num_experts % 16 == 0
    if INPUT_SHAPES[shape_name].kind == "train":
        if ep:
            return "expert_seqpar"
        return "fsdp_seqpar" if n >= 8e9 else "seqpar"
    if ep:
        return "expert"
    return "fsdp" if n >= 60e9 else "megatron"
