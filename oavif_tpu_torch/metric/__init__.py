"""Image-quality metric for the search: the native C SSIMULACRA2
(``native.py``). The device metric is not ported yet."""
