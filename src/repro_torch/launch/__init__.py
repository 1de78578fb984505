# Launchers: the local device mesh (mesh.py) and the retrieval serving CLI
# (serve.py, ``python -m repro_torch.launch.serve``).  Importing this package
# touches no device.
