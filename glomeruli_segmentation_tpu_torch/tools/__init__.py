"""Host analysis scripts, copies of ``glomeruli_segmentation_tpu/tools/``:
``area_stats``, ``bar_plot``, ``bbox_draw``, ``label_transform``,
``loss_plot`` and ``slides_size_stats``, each run as ``python -m
glomeruli_segmentation_tpu_torch.tools.<name>``.  ``matplotlib`` and
``pandas`` are imported inside the functions that plot."""
