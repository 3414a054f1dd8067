"""Data parallelism over several torch devices (port of
``tpubwa.parallel``)."""
