"""Datasets of the ported path (``synthetic.py``)."""
