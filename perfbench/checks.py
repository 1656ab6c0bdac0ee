"""The numbers a training cell's check can compare, each read against
the plain reference (a cell compares those its ``limits/<cell>.json``
names):

``loss_gap``        the largest gap over the recorded steps between the
                    program's loss and the reference's, over the largest
                    reference loss;
``grad_gap``        by the worst leaf, the gap between the norm of the
                    program's first gradient as its optimizer took it
                    (worked out from the optimizer's state after one step)
                    and the reference's clipped gradient's norm, over the
                    larger of that leaf's reference norm and the median
                    leaf's;
``change_gap``      as ``grad_gap``, of the norm of each leaf's change over
                    the recorded steps, leaving out the leaves whose
                    reference gradient is under a thousandth of the median
                    leaf's (they move by round-off alone);
``grad_dir_gap``    by the worst leaf, the norm of the difference between
                    the program's first gradient as its optimizer took it
                    and the reference's clipped gradient, over the larger of
                    that leaf's reference norm and the median leaf's: it
                    sees a change of the gradient's direction, which the
                    norms do not (a family compares it where the norms miss
                    a fault).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import torch

# a leaf whose first reference gradient is under this share of the median
# leaf's is left out of ``change_gap``
QUIET_LEAF = 1e-3


def loss_gap(program: Iterable[float], reference: Iterable[float]) -> float:
    """The largest gap over the steps over the largest reference loss."""
    program, reference = list(program), list(reference)
    scale = max(abs(r) for r in reference) or 1.0
    return max(abs(p - r) for p, r in zip(program, reference)) / scale


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               keep: Optional[Iterable[str]] = None) -> float:
    return worst_leaf_detail(program, reference, keep)["gap"]


def worst_leaf_detail(program: Dict[str, float],
                      reference: Dict[str, float],
                      keep: Optional[Iterable[str]] = None) -> dict:
    """The worst leaf's gap, its name, both norms and the median leaf's
    reference norm."""
    names = list(reference if keep is None else keep)
    median = statistics.median(reference.values())
    gaps = {n: abs(program[n] - reference[n])
            / max(reference[n], median, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return {"gap": gaps[worst], "leaf": worst, "program": program[worst],
            "reference": reference[worst], "median": median}


def direction_detail(program: Dict[str, torch.Tensor],
                     reference: Dict[str, torch.Tensor]) -> dict:
    """``grad_dir_gap`` (``gap``) from the first gradients leaf by leaf
    (the program's may sit on the host, the reference's on the device),
    its leaf, and the same over all leaves together (``whole``: the norm
    of the whole difference over the whole reference's)."""
    diff, ref = {}, {}
    for n, r in reference.items():
        diff[n] = float(torch.linalg.vector_norm(
            program[n].to(r.device, torch.float32) - r))
        ref[n] = float(torch.linalg.vector_norm(r))
    median = statistics.median(ref.values())
    gaps = {n: diff[n] / max(ref[n], median, 1e-30) for n in ref}
    worst = max(gaps, key=gaps.get)
    whole = (sum(d * d for d in diff.values())
             / max(sum(r * r for r in ref.values()), 1e-60)) ** 0.5
    return {"gap": gaps[worst], "leaf": worst, "whole": whole}


def moving_leaves(first_grad: Dict[str, float]):
    median = statistics.median(first_grad.values())
    return [n for n, v in first_grad.items() if v >= QUIET_LEAF * median]


def training_detail(program: dict, reference: dict) -> dict:
    """What ``training_numbers`` reads, leaf by leaf and step by step (for
    the look behind a reading, ``control.py``)."""
    out = {"loss": {"program": program["loss"],
                    "reference": reference["loss"]},
           "grad": worst_leaf_detail(program["grad"], reference["grad"]),
           "change": worst_leaf_detail(program["change"],
                                       reference["change"],
                                       moving_leaves(reference["grad"]))}
    if "grad_vec" in program:
        out["grad_dir"] = direction_detail(program["grad_vec"],
                                           reference["grad_vec"])
    return out


def training_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """``program`` and ``reference`` each hold ``loss`` (a list), ``grad``
    and ``change`` (leaf -> norm)."""
    return {
        "loss_gap": loss_gap(program["loss"], reference["loss"]),
        "grad_gap": worst_leaf(program["grad"], reference["grad"]),
        "change_gap": worst_leaf(program["change"], reference["change"],
                                 moving_leaves(reference["grad"])),
    }
