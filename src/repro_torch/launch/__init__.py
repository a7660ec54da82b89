"""Launchers of the port: the device mesh record and hardware table
(``launch.mesh``) and the serving launcher (``python -m
repro_torch.launch.serve``)."""
