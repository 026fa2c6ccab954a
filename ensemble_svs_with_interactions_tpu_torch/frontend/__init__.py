"""Linguistic front end (copy of the JAX package's ``frontend/merlin.py``)."""
