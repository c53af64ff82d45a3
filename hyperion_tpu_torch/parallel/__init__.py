"""Runs over several ranks (counterpart of ``hyperion_tpu/parallel``):
photon-parallel passes with replicated grids (:mod:`.mesh`), the Lucy
iteration with the grid cut into slabs (:mod:`.spatial`), and the
launcher that starts the ranks (:mod:`.launch`)."""

from .mesh import (resolve_group, run_final_sharded,  # noqa: F401
                   run_lucy_iteration_sharded, run_mono_pass_sharded,
                   run_raytrace_dust_sharded, run_raytrace_source_sharded)
