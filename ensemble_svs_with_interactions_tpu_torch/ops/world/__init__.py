"""WORLD: codec decode and coded-stream synthesis on the device, and the
host-side analysis and coders of feature extraction (``analysis``,
``codec``)."""
