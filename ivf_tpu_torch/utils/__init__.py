"""Weight conversion from the JAX package (``convert.py``)."""
