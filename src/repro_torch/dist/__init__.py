"""Distribution helpers: ``compression`` (the int8 wire of the serving
weight refresh), ``sharding`` (the partition rules and DTensor
placements), ``collectives`` (the sharded regions' collectives and their
gradients) and ``pipeline`` (GPipe over a mesh dim)."""
