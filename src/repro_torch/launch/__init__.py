# Launchers: the device meshes (mesh.py), the retrieval serving CLI
# (serve.py, ``python -m repro_torch.launch.serve``), the training loop
# (train.py) and the dry-run on meta tensors (dryrun.py, ``python -m
# repro_torch.launch.dryrun``).  Importing this package touches no device.
