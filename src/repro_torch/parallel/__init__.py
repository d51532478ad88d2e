"""Process meshes over ``torch.distributed`` and a launcher for local ranks."""
