"""Command lines of the port's evaluation path: ``python -m
phnet_torch.run.test_vil`` (VIL-100), ``python -m phnet_torch.run.test_ol``
(OpenLane-V) and ``python -m phnet_torch.run.evaluate`` (the CULane and
temporal metrics over emitted ``.lines.txt`` files)."""
