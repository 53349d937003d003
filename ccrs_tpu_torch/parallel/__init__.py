"""Multi-device layer: frame-sharded bundle adjustment and detection
(``parallel/mesh.py``)."""
