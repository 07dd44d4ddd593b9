"""The mesh: SPMD ranks over ``torch.distributed`` (counterpart:
llmss_tpu/parallel/).

``mesh.py`` builds a rank's view of a ``dp x sp x tp`` plan and joins the
process group; ``sharding.py`` holds the parameter specs, the rank's
slices and the collectives; ``launch.py`` spawns a world of ranks in one
host; ``smoke.py`` is the two-process smoke run
(``python -m llmss_tpu_torch.parallel.smoke``).
"""

from llmss_tpu_torch.parallel.mesh import (
    AXIS_DP, AXIS_SP, AXIS_TP, Mesh, MeshPlan, default_compute_dtype,
    initialize_runtime, make_mesh,
)

__all__ = [
    "AXIS_DP",
    "AXIS_SP",
    "AXIS_TP",
    "Mesh",
    "MeshPlan",
    "default_compute_dtype",
    "initialize_runtime",
    "make_mesh",
]
