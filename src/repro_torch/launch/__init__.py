"""Launch tooling of the port (the counterpart of ``repro/launch``): the
production meshes (:mod:`.mesh`), the (arch x shape) cells on the
``meta`` device (:mod:`.specs`), their per-device cost
(:mod:`.op_cost`), the H100 roofline (:mod:`.roofline`), the dry run of
every cell (:mod:`.dryrun`) and the hillclimb driver (:mod:`.hillclimb`).
"""
