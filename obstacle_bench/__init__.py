"""The benchmark of ``pointcloud_obstacle_processing_tpu_torch`` on the card
(``run.py``); see ``harness.py``."""
