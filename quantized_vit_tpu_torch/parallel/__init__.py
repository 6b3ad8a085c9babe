"""Multi-process runtime of serving over a 'model' axis: its processes
(:class:`Peers`), their gloo bring-up (:func:`initialize_distributed`),
launchers (:func:`run_processes`, :class:`Workers`), the health
checks, and the tensor-parallel collectives (``tp_comm``)."""

from .distributed import (HealthCheckError, HealthReport, Workers,
                          assert_same_step, check_mesh,
                          collective_health_check, initialize_distributed,
                          run_processes)
from .peers import Peers
from .tp_comm import (COLLECTIVES, all_gather_plain, reduce_scatter_plain,
                      reset_collectives)

__all__ = ["Peers", "initialize_distributed", "run_processes", "Workers", "check_mesh", "HealthCheckError",
           "HealthReport", "collective_health_check", "assert_same_step",
           "COLLECTIVES", "reset_collectives", "all_gather_plain",
           "reduce_scatter_plain"]
