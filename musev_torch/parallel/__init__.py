"""Multi-device topologies (counterpart of ``musev_tpu/parallel/``).

Only the one-device case is ported: ``mesh.cli_topology``. The meshes, the
sharding rules, ring attention and frame parallelism are ROADMAP queue 1,
item 15.
"""
