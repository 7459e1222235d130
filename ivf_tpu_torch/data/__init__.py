"""Datasets of the ported path (``synthetic.py``) and the KTH clip
whitelist (``kth_clips_of_interest.py``)."""
