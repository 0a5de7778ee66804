"""Work counted from a run's inputs, and the card's peaks.

``band_cells`` is a copy of chip_smoke.py's: the cells of a banded global
DP (kernel K3), every row of the target and the columns within w of the
diagonal inside the query.  K3 has no early stop, so these are exactly
the cells its inputs need, whatever implements it.  ``bound_s`` follows
chip_smoke.py's ``bound``: integer instructions over the card's lanes at
its maximum SM clock (PEAKS below, from NVIDIA's data sheet).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

# per card name: streaming multiprocessors and 32-bit integer lanes a
# multiprocessor (one instruction a lane a clock), HBM bytes a second
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"sms": 132, "int32_lanes_per_sm": 64, "hbm_bytes_per_s": 3.35e12},
}
# integer instructions a DP cell of K3 (chip_smoke.py's count)
OPS_PER_CELL = 5


def band_cells(problems: Iterable[Tuple[int, int, int]]) -> int:
    """Cells of every (qlen, tlen, w) problem."""
    total = 0
    for ql, tl, w in problems:
        i = np.arange(tl)
        total += int(np.clip(np.minimum(ql, i + w + 1) - np.maximum(0, i - w), 0, None).sum())
    return total


def bound_s(ops: float, card: str, max_sm_mhz: Optional[float]) -> Optional[float]:
    """Seconds that ``ops`` integer instructions take at the card's peak;
    None for a card not in PEAKS or an unknown clock."""
    peak = PEAKS.get(card)
    if peak is None or not max_sm_mhz:
        return None
    return ops / (peak["sms"] * peak["int32_lanes_per_sm"] * max_sm_mhz * 1e6)
