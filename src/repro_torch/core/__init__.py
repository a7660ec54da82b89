"""The NSFlow generator core of the port: the operation-graph IR, the
analytical models, the dataflow graph, the two-phase DSE, the paper-scale
workload graphs, the torch trace that builds an ``OpGraph`` from a run,
the device-level simulator of the paper's evaluation (``core.simulator``),
mesh folding over a world (``core.folding``) and the memory plan's tile
budgets (``core.memplan``).
"""
