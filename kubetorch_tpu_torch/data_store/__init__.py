"""The port's seam to the data store (``commands.py``): the store protocol
that ``train/checkpoint.py`` and ``serve/rollout.py`` take as an argument,
and the port's copies of the JAX package's content hashing."""
