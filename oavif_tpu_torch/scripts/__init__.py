"""The port's tools: the bench corpus (``corpus``), the corpus harness
(``measure``) and the stage profile (``profile_stages``)."""
