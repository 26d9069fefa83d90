"""Backtracking adaptive-step gradient descent (host numpy).

Reference: code/alg/gd.hxx -- adaptive-step GD with rollback (:210-272:
halve the step while the new energy is worse than the current one,
restore the best iterate).  The fixed-step, momentum and Adam variants
(:159-208, :280-408) map onto torch.optim in learn/sshmt.py.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def adaptive_gd(value_and_grad: Callable, w0, max_iters=100, step0=1.0,
                min_step=1e-10, backtrack=0.5, grow=1.1, tol=0.0,
                verbose=False):
    """Backtracking gradient descent with rollback (gd.hxx:210-272).

    value_and_grad(w) -> (f, g) as numpy arrays.  At each iteration the
    step shrinks (times ``backtrack``) until the energy decreases; a
    successful step grows the step slightly for the next iteration.
    Returns (w, f, history).
    """
    w = np.asarray(w0, dtype=np.float64).copy()
    f, g = value_and_grad(w)
    f = float(f)
    step = step0
    history = [f]
    for it in range(max_iters):
        improved = False
        while step >= min_step:
            w_new = w - step * np.asarray(g)
            f_new, g_new = value_and_grad(w_new)
            f_new = float(f_new)
            if np.isfinite(f_new) and f_new < f - tol:
                w, f, g = w_new, f_new, g_new
                step *= grow
                improved = True
                break
            step *= backtrack
        history.append(f)
        if verbose:
            print(f"\tgd: {it:<6d} fx={f:g} step={step:g}")
        if not improved:
            break
    return w, f, history
