"""Post-order schedules: reordering, live-set depth, register lowering.

A schedule is the tuple list of :meth:`Tree.schedule`, one entry
``(parent, left, right, t_left, t_right)`` per internal node in
post-order.  The traversals run it taller-child-first, which keeps the
number of live intermediate CLVs at O(log taxa) for balanced trees and
O(1) for caterpillars; the batch scorer runs it as data, lowered to
register-machine arrays.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["reorder_schedule", "schedule_depth",
           "compile_register_schedule"]


def reorder_schedule(schedule: Sequence[Tuple], n_leaves: int
                     ) -> List[Tuple]:
    """Reorder a post-order schedule taller-child-first (Sethi-Ullman).

    Returns an equivalent post-order schedule (same nodes, dependencies
    respected) that minimises the peak number of live intermediate CLVs.
    Each entry is (parent, left, right, t_left, t_right, edge) with
    ``edge`` the entry's position in the ORIGINAL schedule.
    """
    children = {p: (l, r, tl, tr, e)
                for e, (p, l, r, tl, tr) in enumerate(schedule)}
    # Heights in one pass: the input schedule is post-order, so both
    # children precede their parent (iterative — a pectinate tree of
    # thousands of taxa must not hit the interpreter recursion limit).
    height: dict = {}
    for (p, l, r, _tl, _tr) in schedule:
        height[p] = 1 + max(height.get(l, 0), height.get(r, 0))

    # Iterative taller-child-first post-order emission (explicit stack;
    # the taller child is pushed LAST so its subtree pops/emits first).
    out: List[Tuple] = []
    root = schedule[-1][0]
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if node not in children:
            continue
        l, r, tl, tr, e = children[node]
        if expanded:
            out.append((node, l, r, tl, tr, e))
        else:
            stack.append((node, True))
            if height.get(l, 0) >= height.get(r, 0):
                stack.append((r, False))
                stack.append((l, False))
            else:
                stack.append((l, False))
                stack.append((r, False))
    assert len(out) == len(schedule)
    return out


def schedule_depth(schedule: Sequence[Tuple], n_leaves: int) -> int:
    """Peak live-CLV count of the (reordered) schedule."""
    live = set()
    peak = 0
    for entry in schedule:
        parent, l, r = entry[0], entry[1], entry[2]
        live.discard(l)
        live.discard(r)
        live.add(parent)
        peak = max(peak, len(live) + 1)  # +1 for in-flight temporaries
    return peak


def compile_register_schedule(schedule: Sequence[Tuple], n_leaves: int):
    """Lower a (reordered) schedule to register-machine arrays.

    Returns ``(arrs, n_slots, root_slot)`` with ``arrs`` the int32 arrays
    (lsrc, lflag, rsrc, rflag, oslot, edge) of length E.  flag==0 means
    the operand is leaf ``src``; flag==1 means slot ``src``.  ``edge`` is
    the entry's last field (its original edge index).  Slots are freed
    right after use, so ``n_slots`` is the schedule's peak live count.
    """
    slot_of = {}
    free: List[int] = []
    n_slots = 0
    lsrc, lflag, rsrc, rflag, oslot, eidx = [], [], [], [], [], []

    def operand(node):
        if node < n_leaves:
            return node, 0
        return slot_of[node], 1

    def release(node):
        if node >= n_leaves:
            free.append(slot_of.pop(node))

    def alloc():
        nonlocal n_slots
        if free:
            return free.pop()
        n_slots += 1
        return n_slots - 1

    for entry in schedule:
        parent, l, r, e = entry[0], entry[1], entry[2], entry[5]
        ls, lf = operand(l)
        rs, rf = operand(r)
        release(l)
        release(r)
        out = alloc()
        slot_of[parent] = out
        lsrc.append(ls)
        lflag.append(lf)
        rsrc.append(rs)
        rflag.append(rf)
        oslot.append(out)
        eidx.append(e)
    root_slot = oslot[-1]
    arrs = tuple(np.asarray(a, np.int32)
                 for a in (lsrc, lflag, rsrc, rflag, oslot, eidx))
    return arrs, n_slots, root_slot
