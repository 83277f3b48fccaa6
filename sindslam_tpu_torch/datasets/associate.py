"""Timestamp association for TUM-format RGB-D datasets (Python 3).

Re-implements the semantics of the reference's ``ORB_SLAM2/EVO/associate.py``
(Python 2): greedy best-first matching of two timestamp lists within a maximum
difference, with an optional fixed offset applied to the second list. The
README prescribes ``--offset -0.033`` for RGB<->depth alignment
(reference ``README.md:78-87``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def read_file_list(path: str) -> Dict[float, List[str]]:
    """Read a TUM-format file (``timestamp data...`` per line, '#' comments)."""
    out: Dict[float, List[str]] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            out[float(parts[0])] = parts[1:]
    return out


def associate(
    first_keys: Sequence[float],
    second_keys: Sequence[float],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[float, float]]:
    """Greedy closest-pair association, identical in result to the reference
    script: enumerate all pairs within ``max_difference``, sort by |dt|, and
    accept each pair whose endpoints are both still unclaimed."""
    first = list(first_keys)
    second = list(second_keys)
    potential = [
        (abs(a - (b + offset)), a, b)
        for a in first
        for b in second
        if abs(a - (b + offset)) < max_difference
    ]
    potential.sort()
    first_free = set(first)
    second_free = set(second)
    matches: List[Tuple[float, float]] = []
    for _, a, b in potential:
        if a in first_free and b in second_free:
            first_free.remove(a)
            second_free.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def associate_window(
    first_keys: Sequence[float],
    second_keys: Sequence[float],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[float, float]]:
    """O(n log n) variant for long sequences: for each key in ``first`` pick the
    nearest key in ``second`` within the window, greedily by |dt|. Equivalent to
    :func:`associate` for well-separated streams (TUM sequences are ~30 Hz with
    ~33 ms spacing, far above typical max_difference)."""
    import bisect

    second = sorted(second_keys)
    cands = []
    for a in first_keys:
        i = bisect.bisect_left(second, a - offset)
        for j in (i - 1, i, i + 1):
            if 0 <= j < len(second):
                dt = abs(a - (second[j] + offset))
                if dt < max_difference:
                    cands.append((dt, a, second[j]))
    cands.sort()
    afree = set(first_keys)
    bfree = set(second)
    matches = []
    for _, a, b in cands:
        if a in afree and b in bfree:
            afree.remove(a)
            bfree.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches
