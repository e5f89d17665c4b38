"""Data parallelism of the port (unast_tpu/parallel/): one process per
device, the global batch's semantics kept by hand (collectives.py), ZeRO
state sharding and the sharded train step (mesh.py), the multi-process
launch (multihost.py). Import the submodules; this package imports none of
them, so that the model code can use collectives.py alone."""
