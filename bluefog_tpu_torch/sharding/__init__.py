"""The partition rule table (``sharding/rules.py`` of the JAX package)."""
