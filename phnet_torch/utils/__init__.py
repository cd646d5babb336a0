"""Utilities of the port: the reference-checkpoint import
(``torch_import``) and the segmentation mask utilities (``masks``)."""
