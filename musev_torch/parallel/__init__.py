"""Multi-device topologies (counterpart of ``musev_tpu/parallel/``), one
process per device on ``torch.distributed``: ``mesh`` (meshes, the
differentiable collectives, the CLIs' topology), ``context`` (the mesh axes
a denoise step runs under), ``frame_parallel`` (the frame rows of every
window sharded over the ranks), ``ring_attention`` (sequence-parallel
attention) and ``sharding`` (tensor-parallel rules).
"""
