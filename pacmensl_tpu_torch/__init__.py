"""pacmensl_tpu_torch: the adaptive Finite State Projection solver in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``pacmensl_tpu`` (JAX/Pallas for the TPU), with the same
subpackage layout.  It imports no JAX.  This package holds the transient
solve on the dense-box backend, with the Krylov integrator for
time-invariant models and BDF with matrix-free GMRES for time-varying
ones (``odes_type="auto"`` picks)::

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

    h = pt.models.hog1p_5d()            # time-varying: BDF
    s = pt.FspSolverMultiSinks(device="cuda")
    s.set_model(h.model)
    s.set_constraint_functions(h.constraint)
    s.set_initial_bounds(h.bounds)
    s.set_expansion_factors(h.expansion_factors)
    s.set_initial_distribution(h.x0, h.p0)
    dist = s.solve(t_final=180.0, fsp_tol=1e-4)

Forward sensitivities (a ``SensModel``; BDF by default), the Fisher
information and the smFISH likelihood gradient::

    hs = pt.models.hog1p_5d_sens()      # parameters (trans, gamma1)
    s = pt.SensFspSolverMultiSinks(device="cuda")
    ...                                 # as above, with hs
    sd = s.solve(t_final=180.0, fsp_tol=1e-4)   # sd.p, sd.dp [2, n]
    fim = sd.compute_fim()
    data = pt.SmFishSnapshot(observed_counts)   # [cells, species]
    grad = pt.smfish_gradient(data, sd, measured_species=[1, 2])

Pass ``device="cpu"`` to run on the host, where the box kernel's plain
PyTorch version takes the kernel's place.

A sharded solve splits the box over the ranks of a ``torch.distributed``
group (NCCL, one rank per card; start one process per card, for example
with ``torchrun --nproc-per-node=<cards>``), every rank running the same
script::

    pt.environment.init()               # joins torchrun's group
    s = pt.FspSolverMultiSinks(odes_type="krylov", mesh=pt.make_mesh())
    ...                                 # as above
    dist = s.solve(t_final=10.0, fsp_tol=1e-4)   # on every rank
    pt.environment.finalize()
"""
from . import config  # noqa: F401  (sets the TF32 switches)

from .config import DEFAULT_DTYPE, resolve_device  # noqa: F401
from .sys import errors  # noqa: F401
from .sys.errors import (  # noqa: F401
    PacmenslError, SetupError, StateSpaceError, IntegratorError)
from .sys.events import EventLog, StepTrace  # noqa: F401
from .models.model import Model, SensModel  # noqa: F401
from .models import library as models  # noqa: F401
from .statespace.constraints import ConstraintSet  # noqa: F401
from .statespace.box_space import BoxStateSpace  # noqa: F401
from .ops.vecops import FspVector  # noqa: F401
from .ops.box_operator import BoxOperator  # noqa: F401
from .solvers.base import ODESolverType  # noqa: F401
from .solvers.krylov import KrylovSolver  # noqa: F401
from .solvers.bdf import BdfSolver  # noqa: F401
from .fsp.distribution import DiscreteDistribution  # noqa: F401
from .fsp.solver import FspSolverMultiSinks  # noqa: F401
from .sensfsp.sens_distribution import SensDiscreteDistribution  # noqa: F401
from .sensfsp.sens_solver import SensFspSolverMultiSinks  # noqa: F401
from .smfish.snapshot import (  # noqa: F401
    SmFishSnapshot, smfish_loglikelihood, smfish_gradient)
from .pdo.pdo import Pdo  # noqa: F401
from .sys import environment  # noqa: F401
from .sys.environment import Environment  # noqa: F401
from .parallel.mesh import StateMesh, make_mesh  # noqa: F401
from . import interop  # noqa: F401

__version__ = "0.3.0"
