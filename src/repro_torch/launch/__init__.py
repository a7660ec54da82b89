"""Launchers of the port: the device mesh record and hardware table
(``launch.mesh``), the serving and training launchers (``python -m
repro_torch.launch.serve`` / ``launch.train``), the dry-run
(``launch.dryrun``) and its roofline (``launch.roofline``)."""
