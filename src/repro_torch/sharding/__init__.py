"""The multi-card mesh's partition rules (port of ``src/repro/sharding``):
``plan.MeshPlan`` (how an architecture factors the production mesh),
``specs`` (the per-leaf partition rules and their DTensor placements) and
``state`` (a round state moved onto a ``DeviceMesh`` and back, and the
collectives of the sharded round over its (group, client) axes)."""
