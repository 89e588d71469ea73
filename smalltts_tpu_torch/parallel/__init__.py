"""Data and tensor parallelism on torch.distributed (port of smalltts_tpu/parallel/).

One rank is one device. `mesh.make_mesh(dp, tp)` lays the world's ranks out
as a (dp, tp) grid, tp groups on consecutive ranks; `mesh.shard_params`
keeps this rank's tensor-parallel shard of a parameter tree (whole heads of
each fused part); `comm` holds the collectives and the autograd functions
that the models and the step factories call while a mesh is in use
(`mesh.use`); `multihost` joins a job from the environment and writes
single-writer checkpoints.
"""
