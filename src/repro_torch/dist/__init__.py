"""The mesh: sharded training and serving with packed collectives (port
of ``repro/dist``).

A mesh is one process per device slot, a rank, joined in a
``torch.distributed`` process group (:mod:`repro_torch.dist.mesh`);
:mod:`repro_torch.dist.launch` runs a function on N local ranks.
Gradient exchange in training and logits in serving cross the mesh as
packed values + occupancy-mask words through ``packed_all_gather`` /
``packed_reduce_scatter`` (:mod:`repro_torch.dist.collectives`), with the
reference's byte accounting.  :mod:`repro_torch.dist.train` and
:mod:`repro_torch.dist.serve` build the sharded session steps.

Import submodules directly (``from repro_torch.dist import collectives``).
"""
