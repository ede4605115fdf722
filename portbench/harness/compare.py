"""The comparison that decides ``correct`` for a training-like loop.

The program's first steps, driven through the window's own call in
set-up, are held to the plain reference's steps from the same state:

- ``loss_gap``: the largest relative gap of a step's loss (summed over the
  window's views);
- ``grad_gap``: the first gradient as the optimizer got it (read back from
  its state after one step), by the worst leaf: the gap between the norms
  of the program's and the reference's gradient of a leaf, over the larger
  of the reference's norm of that leaf and the median leaf's;
- ``change_gap``: the same of the parameters' change over the steps
  before the densify, leaving out leaves whose reference gradient is under
  a thousandth of the median leaf's (they move under Adam by round-off
  alone);
- ``stat_gap``: the larger relative gap of the norms of the two
  densification statistics (the summed screen-gradient norms and the
  counts of views) after those steps, each over its own reference norm;
- ``densify_gap``: the same of the change of what the map holds (each
  leaf with its free slots zeroed) over the step that densifies and
  prunes: what was pruned leaves it, the children enter it.

Each number is checked against the cell's limit; a non-finite number
fails.
"""

from __future__ import annotations

import math
import statistics


def _norm(x) -> float:
    return float(x.double().norm())


def leaf_gaps(prog: dict, ref: dict, keep=None):
    """(worst gap, {leaf: gap}) of the norms of ``prog`` and ``ref``
    ({leaf: tensor}), over the leaves in ``keep`` (all when None)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: _norm(ref[k]) for k in ref}
    med = statistics.median(rn[k] for k in names)
    gaps = {}
    for k in names:
        den = max(rn[k], med)
        pn = _norm(prog[k])
        gaps[k] = abs(pn - rn[k]) / den if den > 0 else (
            0.0 if pn == 0 else math.inf)
    return max(gaps.values()), gaps


def training_numbers(prog: dict, ref: dict):
    """The numbers and their detail from ``prog`` and ``ref``, each a dict
    with ``losses`` [steps], ``grads`` {leaf: first gradient}, ``change``
    {leaf: change over the steps before the densify}, ``stats`` {accum,
    denom} after them, ``densify`` {leaf: change of the map over the
    densify's step} and ``active`` (Gaussians before and after it)."""
    loss_gap = max(abs(p - r) / abs(r) if r else abs(p)
                   for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grads = leaf_gaps(prog["grads"], ref["grads"])
    gn = {k: _norm(v) for k, v in ref["grads"].items()}
    med = statistics.median(gn.values())
    keep = {k for k, v in gn.items() if v >= 1e-3 * med}
    change_gap, changes = leaf_gaps(prog["change"], ref["change"], keep)
    stats = {k: leaf_gaps({k: prog["stats"][k]}, {k: ref["stats"][k]})[0]
             for k in ref["stats"]}
    stat_gap = max(stats.values())
    densify_gap, dens = leaf_gaps(prog["densify"], ref["densify"])
    numbers = dict(loss_gap=loss_gap, grad_gap=grad_gap,
                   change_gap=change_gap, stat_gap=stat_gap,
                   densify_gap=densify_gap)
    st = ref["stats"]
    hot = st["accum"] / st["denom"].clamp(min=1e-12)
    detail = dict(grad_leaves=grads, change_leaves=changes,
                  left_out=sorted(set(gn) - keep), stat_leaves=stats,
                  densify_leaves=dens, active_program=prog["active"],
                  active_reference=ref["active"],
                  densified_reference=ref.get("densified"),
                  stat_max_reference=float(hot.max()),
                  losses_program=prog["losses"],
                  losses_reference=ref["losses"])
    return numbers, detail


def verdict(numbers: dict, limits: dict):
    """(correct, checks): checks maps each number to its value and limit."""
    checks = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
