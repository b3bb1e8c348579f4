"""The port's example scripts, counterparts of the JAX package's
``examples/*.py`` (``python -m pacmensl_tpu_torch.examples.<name>``).
Each takes PETSc-style options with the reference script's names and
defaults, and ``-device`` (``cuda`` by default; ``cpu`` runs on the
host)."""
