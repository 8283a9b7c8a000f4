"""The reference ``utils`` package (timing, labels) on the port:
counterparts of the root ``utils/timing.py`` and ``utils/labels.py``."""
