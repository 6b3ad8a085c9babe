"""Multi-process runtime of FSDP serving: the 'model' axis's processes
(:class:`Peers`), their gloo bring-up (:func:`initialize_distributed`)
and a launcher (:func:`run_processes`)."""

from .distributed import initialize_distributed, run_processes
from .peers import Peers

__all__ = ["Peers", "initialize_distributed", "run_processes"]
