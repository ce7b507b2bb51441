"""Traffic generators, one module each, found by the ``generator`` that a
``traffic/<mix>.json`` names (``manifest.generator``)."""
