"""The comparison that decides ``correct``: the numbers compared between
the program's run and the plain reference, and their limits.

Training (``train_numbers``; the reference takes step 0's bits from the
program's log, ``reference/train.py``):

* ``bit_gap``: the widest gap by which one of step 0's sampled bits lies
  on the wrong side of its Philox draw, in the reference's probabilities;
* ``loss_gap``: step 0's six logged losses, the worst term's gap, over the
  larger of its reference value and the terms' median;
* ``grad_gap``: each leaf's clipped gradient norm at step 0 (the program's
  worked out from its RMSprop state after that one update), the worst
  leaf's gap, over the larger of its reference norm and the leaves'
  median;
* ``change_gap``: each leaf's change over the checked steps, its gap taken
  as ``grad_gap``'s, the median leaf's, against the closest of the
  reference's trajectories (the later steps draw their own bits, and a
  draw that falls between the two sides' probabilities moves every leaf:
  the reference follows its own draws and, one at a time, each of its
  nearest ties taken the other way; see ``reference/train.py``);
* ``dev_gap``: the gap of the dev sweep's top-k accuracy after step 0.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias under a softmax, which no loss moves) are left out of
``grad_gap`` and ``change_gap``: they move by round-off alone.

Serving (``serve_numbers``), the widest over the sampled requests: a
served bit's gap to the wrong side of the reference's rounding, the
answer's log-probability gap, and the served prediction's gap below the
reference's best.

A cell's limits file (``limits/<cell>.json``) names the numbers it
compares, with the readings each limit was set from; a number it leaves
out is computed and shown, not compared.
"""

import json
import os
import statistics
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
NEGLIGIBLE = 1e-3


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys
          ) -> List[float]:
    keys = list(keys)
    med = statistics.median(abs(ref[k]) for k in keys)
    return [abs(prog[k] - ref[k]) / max(abs(ref[k]), med) for k in keys]


def counted_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= NEGLIGIBLE * med]


def _closest(prog: dict, refs: List[dict], leaves) -> Tuple[dict, float]:
    """The reference trajectory whose median leaf's change gap is least,
    and that gap."""
    return min(((r, statistics.median(_gaps(prog["change_norms"],
                                            r["change_norms"], leaves)))
                for r in refs), key=lambda x: x[1])


def train_numbers(prog: dict, refs: List[dict]) -> Dict[str, float]:
    """``refs`` are the reference's trajectories on ``prog``'s first
    bits (``reference/train.py:follow_branches``)."""
    ref = refs[0]
    leaves = counted_leaves(ref["grad_norms"])
    return {
        "bit_gap": ref["bit_gap"],
        "loss_gap": max(_gaps(prog["losses"], ref["losses"], ref["losses"])),
        "grad_gap": max(_gaps(prog["grad_norms"], ref["grad_norms"],
                              leaves)),
        "change_gap": _closest(prog, refs, leaves)[1],
        "dev_gap": abs(prog["dev_acc"] - ref["dev_acc"]),
    }


def worst_change(prog: dict, refs: List[dict]) -> float:
    """The worst leaf's change gap against ``change_gap``'s trajectory:
    shown beside it, not compared."""
    leaves = counted_leaves(refs[0]["grad_norms"])
    ref = _closest(prog, refs, leaves)[0]
    return max(_gaps(prog["change_norms"], ref["change_norms"], leaves))


def serve_numbers(judged: List[dict]) -> Dict[str, float]:
    return {k: max(j[k] for j in judged) for k in judged[0]}


def limits_for(cell: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return json.load(f)["limits"]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, list]]:
    """``correct`` (every number that has a limit within it) and
    ``{name: [number, limit]}`` of those numbers."""
    shown = {k: [numbers.get(k), limits[k]] for k in limits}
    ok = all(v is not None and v == v and v <= lim
             for v, lim in shown.values())
    return ok, shown
