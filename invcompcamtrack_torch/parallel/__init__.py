from invcompcamtrack_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
