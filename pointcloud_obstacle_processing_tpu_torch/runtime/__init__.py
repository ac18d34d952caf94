"""Host runtime: pub/sub bus, tf buffer, node driver, launch composition
(counterpart of ``pointcloud_obstacle_processing_tpu/runtime``)."""

from .bus import MessageBus, Publisher, Subscription
from .driver import ObstacleDetectionNode, POINT_TOPIC
from .msgs import (
    Header,
    OccupancyGridMsg,
    PointCloud2Msg,
    PointIndicesArrayMsg,
    PointWithRadMsg,
    TransformStampedMsg,
)
from .tf import TransformBuffer
