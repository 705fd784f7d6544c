"""Target-quality search of the port: the search algorithms
(``search.py``, a copy of the reference's), the drivers (``driver.py``)
and the corpus pipeline (``pipeline.py``)."""
