"""The ImageNet example (``main_amp.py``)."""
