"""CPU tests of the benchmark (cards: the ``cuda`` marker)."""
