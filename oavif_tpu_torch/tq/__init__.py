"""Target-quality search driver of the port (``driver.py``); the search
algorithms are the reference's ``oavif_tpu.tq.search``."""
