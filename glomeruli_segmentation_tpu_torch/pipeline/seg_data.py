"""Detect -> segment handoff constants.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/seg_data.py``.  Only
``MAGNIFICATION`` is ported so far: the end-to-end pipeline names each
crop's labelme JSON by its box in level-0/8 coordinates
(``make_seg_data.py:193-197``).  The segmentation dataset writer (crops
and ground-truth label PNGs from the merged CSV and annotation XMLs) comes
later.
"""

MAGNIFICATION = 8
