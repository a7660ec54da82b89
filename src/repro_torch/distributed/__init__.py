"""Distribution of the port: the sharding rules (``sharding_rules``), the
tensor-parallel context the layers read (``constraints``) and the world of
processes that serves an LM tensor-parallel (``world``)."""
