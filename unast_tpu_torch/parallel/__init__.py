"""Parallelism of the port (unast_tpu/parallel/): one process per device,
the global batch's semantics and the split layers' collectives kept by
hand (collectives.py), the dp x tp x ep mesh, its sharding rules, ZeRO
state sharding and the sharded steps (mesh.py), the multi-process launch
(multihost.py). Import the submodules; this package imports none of them,
so that the model code can use collectives.py alone."""
