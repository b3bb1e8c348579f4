"""fspbench: the benchmark of ``pacmensl_tpu_torch`` on one NVIDIA card
(see README.md)."""
