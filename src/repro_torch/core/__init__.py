"""The NSFlow generator core of the port: the operation-graph IR, the
analytical models, the dataflow graph, the two-phase DSE, the paper-scale
workload graphs and the torch trace that builds an ``OpGraph`` from a run.
"""
