"""Parallelism of the port (unast_tpu/parallel/): one process per device,
the global batch's semantics and the split layers' collectives kept by
hand (collectives.py: dp reductions, the tp / ep pairs, the sp time
split, gather and halos, the pp point-to-point hops), the dp x tp x ep x
sp x pp mesh, its sharding rules, ZeRO state sharding and the sharded
steps (mesh.py), GPipe stages (pipeline.py: set_pp_mesh, gpipe_stack,
make_pp_mesh, stack_for_pipeline, pipeline_encoder), the multi-process
launch (multihost.py). Import the submodules; this package imports none
of them, so that the model code can use collectives.py alone."""
