"""Fleet fabric: multi-host serving on top of the preforked front door
(port of ``analytics_zoo_tpu.serving.fabric``).

One :class:`~analytics_zoo_tpu_torch.serving.fabric.door.FleetDoor` per host
generalizes the single-host front door to N hosts sharing one
filesystem rendezvous directory:

- :mod:`~analytics_zoo_tpu_torch.serving.fabric.membership` — the shared,
  epoch-numbered cluster view (heartbeat files + staleness detection;
  no external coordination service);
- :mod:`~analytics_zoo_tpu_torch.serving.fabric.door` — cross-host sticky
  routing (``TrafficPolicy`` interval-point math over the host
  roster), replicated admin with stale-view rejection, and the
  fleet-level metrics/trace merges;
- :mod:`~analytics_zoo_tpu_torch.serving.fabric.coopcache` — the
  content-addressed tree codec and peer client that make the result
  cache cooperative across hosts;
- :mod:`~analytics_zoo_tpu_torch.serving.fabric.autoscaler` — queue-depth
  driven per-host worker autoscaling.
"""

from analytics_zoo_tpu_torch.serving.fabric.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
)
from analytics_zoo_tpu_torch.serving.fabric.coopcache import (
    PeerCacheClient,
    TREE_CONTENT_TYPE,
    decode_tree,
    encode_tree,
)
from analytics_zoo_tpu_torch.serving.fabric.door import (
    FleetConfig,
    FleetDoor,
    fleet_pick,
)
from analytics_zoo_tpu_torch.serving.fabric.membership import (
    ClusterView,
    HostRecord,
    Membership,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "ClusterView",
    "FleetConfig",
    "FleetDoor",
    "HostRecord",
    "Membership",
    "PeerCacheClient",
    "TREE_CONTENT_TYPE",
    "decode_tree",
    "encode_tree",
    "fleet_pick",
]
