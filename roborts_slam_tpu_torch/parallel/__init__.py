"""Multi-process execution on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/``: ``mesh`` (named axes over
process groups), ``dist_spa`` (the SPA solve with its edges sharded over an
axis), ``sharded_match`` (batches of chain and scan matches fanned out over
an axis) and ``multihost`` (bring-up, the scaling harness, the synthetic
loop graph and a launcher of local ranks). Where the JAX package runs one
program over a device mesh and lets the compiler partition it, every rank
here is a process with one device that takes its own shard explicitly and
sums with ``all_reduce`` over its axis's group.
"""
