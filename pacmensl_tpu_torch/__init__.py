"""pacmensl_tpu_torch: the adaptive Finite State Projection solver in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``pacmensl_tpu`` (JAX/Pallas for the TPU), with the same
subpackage layout.  It imports no JAX.  This package holds the transient
solve on the dense-box backend with the Krylov integrator::

    import pacmensl_tpu_torch as pt

    b = pt.models.repressilator()
    s = pt.FspSolverMultiSinks(backend="box", odes_type="krylov",
                               device="cuda")
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    dist = s.solve(t_final=10.0, fsp_tol=1e-4)

Pass ``device="cpu"`` to run on the host, where the box kernel's plain
PyTorch version takes the kernel's place.
"""
from . import config  # noqa: F401  (sets the TF32 switches)

from .config import DEFAULT_DTYPE, resolve_device  # noqa: F401
from .sys import errors  # noqa: F401
from .sys.errors import (  # noqa: F401
    PacmenslError, SetupError, StateSpaceError, IntegratorError)
from .sys.events import EventLog, StepTrace  # noqa: F401
from .models.model import Model  # noqa: F401
from .models import library as models  # noqa: F401
from .statespace.constraints import ConstraintSet  # noqa: F401
from .statespace.box_space import BoxStateSpace  # noqa: F401
from .ops.vecops import FspVector  # noqa: F401
from .ops.box_operator import BoxOperator  # noqa: F401
from .solvers.base import ODESolverType  # noqa: F401
from .solvers.krylov import KrylovSolver  # noqa: F401
from .fsp.distribution import DiscreteDistribution  # noqa: F401
from .fsp.solver import FspSolverMultiSinks  # noqa: F401
from . import interop  # noqa: F401

__version__ = "0.1.0"
