"""PyTorch/CUDA port of mantaflow_tpu.

Same modules, state layouts and op semantics as the JAX package: grids are
``(z, y, x)``, MAC fields ``(3, z, y, x)`` float32, flags int32, FLIP
particles in ``(P, T)`` cell buckets. The kernels of the smoke and bucketed
FLIP steps are hand-written CUDA for Hopper (``csrc/``); on a CPU tensor
each kernel wrapper runs its plain PyTorch version instead.
"""

import torch

#: the device an entry point uses when its caller names none; None means
#: CUDA. The scene runner sets it for the scene it runs (``--device``).
default_device = [None]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller, or the
    scene runner, names one.

    Raises when no device is given and no GPU is present, so an entry point
    never continues quietly on the CPU."""
    if device is None:
        device = default_device[0]
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return torch.device("cuda")


# The scene API (``from mantaflow_tpu_torch import *``), the same surface as
# the JAX package's; imported after ``resolve_device``, which its modules
# import from here.
from .scene.api import *  # noqa: F401,F403,E402
from .scene.api import (  # noqa: F401,E402
    Solver, FluidSolver, FlagGrid, RealGrid, IntGrid, Vec3Grid, MACGrid,
    LevelsetGrid, Box, Sphere, Cylinder, Slope, NullShape, NoiseField,
    Timings, vec3, vec3i, mantaMsg, setDebugLevel,
)
from .scene.papi import *  # noqa: F401,F403,E402
from .scene.papi import (  # noqa: F401,E402
    BasicParticleSystem, ParticleIndexSystem, PdataReal, PdataInt, PdataVec3,
)

from .scene.ops2 import *  # noqa: F401,F403,E402
from .scene.zflip_api import *  # noqa: F401,F403,E402
from .scene.mesh_api import (  # noqa: F401,E402
    Mesh, smoothMesh, subdivideMesh, killSmallComponents,
)
from .scene.api import (  # noqa: F401,E402
    Grid4Base, Grid4Real, Grid4Int, Grid4Vec3, Grid4Vec4, getSliceFrom4d,
    setSliceTo4d, interpolateGrid4d,
)
from .scene.timing_api import Timings, enableTimings  # noqa: F401,E402
from .scene.vortex_api import (  # noqa: F401,E402
    VortexParticleSystem, TurbulenceParticleSystem, VortexSheetMesh,
    VPseedK41, markAsFixed, vorticitySource, smoothVorticity, VICintegration,
    densityFromLevelset, texcoordInflow, meshSmokeInflow,
)
from .scene.io_api import (  # noqa: F401,E402
    save, load, save_checkpoint, load_checkpoint, projectPpmFull,
)

VecGrid = Vec3Grid  # manta alias (grid.h:252)

__version__ = "0.1.0"
