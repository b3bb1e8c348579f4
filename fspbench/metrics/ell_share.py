"""Routing (``fsp/solver.py`` ``_choose_backend``,
``_should_leave_box``): the share of solves that ended on the compressed
(ELL) backend, in percent."""


def read(ctx):
    return ctx.per_solve(lambda s: 100.0 * (s.backend == "ell"))
