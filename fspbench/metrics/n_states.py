"""State space (``statespace/box_space.py``, ``state_set.py``): the
returned distribution's state count, per solve."""


def read(ctx):
    return ctx.per_solve(lambda s: s.n_states)
