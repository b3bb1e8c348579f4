"""Integrator: operator actions (``EventLog`` count ``RHSEvaluation``)
per solve."""


def read(ctx):
    return ctx.per_solve(lambda s: s.event_count("RHSEvaluation"))
