"""Distribution of the port: the sharding rules (``sharding_rules``), the
tensor-parallel context the layers read and the SPMD collectives
(``constraints``), the world of processes that serves an LM
tensor-parallel and runs SPMD bodies (``world``), the pipeline
(``gpipe``) and error-feedback compression (``compression``)."""
