"""The comparison that decides ``correct``: a solve of the program against
the plain reference's solve of the same request (:mod:`.reference`).

Both truncations leave out mass, so the program's ``p`` lies below the
CME's solution at every state (exactly so without rounding) and the
reference's, at its much tighter tolerance, lies within its own lost
mass of it.  Three numbers follow:

* ``l1``: sum |p - p_ref| over both state sets.  The configuration states
  its limit: the program certifies ``fsp_tol`` (with the solver's slack
  of 1e-3 ``fsp_tol``), the reference its own lost mass.
* ``excess``: sum of max(0, p - p_ref) over the program's states, the
  mass the program puts above the solution: rounding and the
  integrator's error only, since a truncation only takes mass away.
* ``balance``: |1 - sum(p) - sum(sinks)|, how far the distribution and
  its sink masses miss the unit mass they conserve.  Every transition out
  of the truncation adds its flow to the sink of each constraint it
  violates, so a sound solve reads the flow that left through two
  constraints at once (``signed_balance`` negative); mass made or lost by
  rounding or by the integrator adds to it, whichever its sign.  That
  flow is the truncation's: a looser truncation lets more of it out (a
  solve to an earlier ``t_final`` may lose more before then), so the
  limit holds at the cell's own request.  The reference's sinks count it
  the same way, so the control reads the same quantity.

``l1``'s limit is the configuration's; a configuration's file sets the
limits of the others it compares (``check``), each from the readings of
sound runs and of the control (PERF.md).
"""
from __future__ import annotations

import numpy as np
import torch


def compare(states, p, sinks, ref) -> dict:
    """``states [n, S]``, ``p [n]`` and ``sinks [n_c]`` of the program's
    distribution (host arrays, in the configuration's species order)
    against a :class:`~.reference.RefResult`."""
    dev = ref.p.device
    idx = ref.box.index(torch.as_tensor(np.ascontiguousarray(states)))
    pr = ref.p.to(torch.float64)
    on = idx >= 0
    ref_at = torch.where(on, pr[idx.clamp(min=0)], 0.0)
    d = torch.as_tensor(np.asarray(p, dtype=np.float64), device=dev) - ref_at
    ref_rest = float(pr.sum()) - float(ref_at.sum())
    signed = 1.0 - float(np.sum(p)) - float(np.sum(sinks))
    return {
        "l1": float(d.abs().sum()) + ref_rest,
        "excess": float(d.clamp(min=0).sum()),
        "balance": abs(signed),
        "signed_balance": signed,
        "outside_ref": int((~on).sum()),
        "prog_mass": float(np.sum(p)),
        "ref_lost": float(ref.lost),
    }


def limits(cfg) -> dict:
    """Each compared number's limit: ``l1`` the configuration's (the
    program's ``fsp_tol`` with its 1e-3 slack, plus the reference's own
    tolerance), the others as the configuration's ``check`` sets them."""
    out = {"l1": cfg.fsp_tol * (1.0 + 1e-3)
           + float(cfg.data["reference"]["tol"])}
    out.update({k: float(v) for k, v in cfg.data["check"].items()})
    return out
