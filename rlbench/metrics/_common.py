"""Helpers the per-layer metric readers share. A reader's `read(rec)`
returns a number, or None when the run's record has nothing to read."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from rlbench import flops


def window_spans(rec: Dict, label: str) -> List[Tuple]:
    lo, hi = rec["t_open"], rec["t_close"]
    return [s for s in rec.get("spans", []) if s[0] == label
            and lo <= s[1] and s[2] <= hi]


def ms_per_ktok(rec: Dict, label: str,
                tokens: Optional[float]) -> Optional[float]:
    spans = window_spans(rec, label)
    if not spans or not tokens:
        return None
    return sum(s[2] - s[1] for s in spans) * 1e3 / (tokens / 1e3)


def mfu(rec: Dict, trained: float, forward: float) -> Optional[float]:
    w = rec["window"]
    if not w["seconds"]:
        return None
    n = flops.active_params_no_embed(rec["cfg"])
    return flops.mfu_percent(flops.model_flops(n, trained, forward),
                             w["seconds"])


def idle(rec: Dict) -> Optional[float]:
    tr = rec.get("traced")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def device_seconds(traced: Optional[Dict], subs) -> Optional[float]:
    """Device seconds of the traced kernels whose names hold any of
    `subs`; None when none ran."""
    if not traced:
        return None
    s = sum(v for k, v in traced["by_name"].items()
            if any(x in k for x in subs))
    return s or None
