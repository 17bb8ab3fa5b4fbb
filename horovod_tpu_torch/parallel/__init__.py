"""Parallelism library of the port: the process-group meshes
(:mod:`.mesh`), the collectives with JAX's transposes
(:mod:`.collectives`), the two-tier reduction (:mod:`.hierarchical`),
ring and Ulysses attention, tensor, pipeline and expert parallelism."""
