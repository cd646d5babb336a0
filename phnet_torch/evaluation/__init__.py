"""Evaluation of the port: the CULane ``.lines.txt`` format (``emit``), the
CULane F1 / mIoU metric in Python (``culane_metric``) and native
(``native_eval``), the temporal stability metric (``temporal``), the
TuSimple accuracy (``tusimple_acc``), the J and F mask metrics
(``video_metrics``) and the frozen datalists (``fixtures``)."""
