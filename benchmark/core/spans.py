"""The program's root spans of a window's calls."""

from __future__ import annotations


def window_records(ctx, name: str):
    """The program's root span ``name`` of each window call, in order
    (``glia_tpu_torch.utils.profiling.records``); None where the program
    keeps no such records or a call has not exactly one."""
    from glia_tpu_torch.utils import profiling

    recs = getattr(profiling, "records", None)
    calls = ctx.window.calls
    if recs is None or not calls:
        return None
    lo, hi = ctx.window.t_open, calls[-1].t1
    mine = [r for r in list(recs) if r.name == name and lo <= r.t0 <= hi]
    if len(mine) != len(calls) or any(
            not c.t0 <= r.t0 <= c.t1 for c, r in zip(calls, mine)):
        return None
    return mine
