"""Launchers of the port: ``train`` (any registered arch, with
checkpoints, resume and failure injection), ``serve`` (the retrieval
serving loop), ``dryrun`` (every registry cell traced on ``meta``, its
cost model from ``analysis``, on the logical meshes of ``mesh``)."""
