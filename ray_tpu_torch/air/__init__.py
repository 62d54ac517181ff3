"""AIR-style shared storage (reference ``python/ray/air/``).

Only ``storage`` is here: the raylet spills objects to URIs through it.
The rest of the JAX package's ``air`` (configs, checkpoints, the session
facade) comes with Train (ROADMAP.md, queue 1, item 4).
"""
