"""WORLD codec decode and coded-stream synthesis on the device."""
