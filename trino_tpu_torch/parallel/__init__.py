"""The mesh tier: one controller drives a list of shards (mesh.py), the
collective exchange between them (exchange.py), whole-fragment stage
programs (stages.py) and the executor that runs any plan over the mesh
(dist_executor.py)."""
