"""Evaluation helpers of the port: the CULane ``.lines.txt`` format
(``emit``)."""
